"""The port's viewer (diffdart_tpu_torch/viewer/) on the CPU: the counterpart
of tests/test_viewer.py, and its JSON held to the JAX package's.

* scene_description against the JAX package's on cube_drop, the
  half-cheetah and the octahedron (a CONVEX geom: its hull vertices): the
  same structure, numbers within 1e-9.
* state_frame and trajectory_frames against the JAX package's on the same
  q: within 1e-5, one unit in the fifth place (both round to 5 places, and
  a value on a rounding boundary may round either way; the slack of 1e-6
  of the tolerance covers the binary representation of that difference).
* save_html, the HTTP page, the WebSocket stream, the drag round trip, the
  keydown listener and renderTrajectory, each on 127.0.0.1, port 0, with
  5 s socket timeouts.
"""
import base64
import hashlib
import json
import os
import socket
import struct
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffdart_tpu.viewer import protocol as jax_protocol
from diffdart_tpu_torch.dynamics.model import State
from diffdart_tpu_torch.math.lie import quat_normalize
from diffdart_tpu_torch.models import cheetah_init_q, cube_drop, half_cheetah
from diffdart_tpu_torch.sim import step as S
from diffdart_tpu_torch.viewer import (
    GUIWebsocketServer, save_html, scene_description, state_frame, trajectory_frames)

from test_torch_tile_convex import octa_model
from test_torch_vmap_dynamics import jax_model_of

F64 = torch.float64


def _cube():
    return cube_drop(dt=2e-3, dtype=F64, device="cpu")


def _q(m, name, n, seed):
    """(n, nq) positions: free bodies at random attitudes, the cheetah's
    joints perturbed."""
    rng = np.random.RandomState(seed)
    if name == "half_cheetah":
        return cheetah_init_q(m).repeat(n, 1) + 0.3 * torch.tensor(rng.randn(n, m.nq))
    quat = quat_normalize(torch.tensor(rng.randn(n, 4)))
    return torch.cat([quat, torch.tensor(rng.randn(n, 3))], 1)


MODELS = {
    "cube_drop": _cube,
    "half_cheetah": lambda: half_cheetah(dt=2e-3, dtype=F64, device="cpu"),
    "octahedron": octa_model,
}


@pytest.fixture(scope="module", params=sorted(MODELS))
def models(request):
    m = MODELS[request.param]()
    return request.param, m, jax_model_of(m)


def _close_json(a, b, tol, path="$"):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for k in a:
            _close_json(a[k], b[k], tol, f"{path}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close_json(x, y, tol, f"{path}[{i}]")
    elif isinstance(a, float):
        assert isinstance(b, float) and abs(a - b) <= tol * (1 + 1e-6), (path, a, b)
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


def test_scene_description_matches_jax(models):
    name, m, jm = models
    got = scene_description(m)
    _close_json(got, jax_protocol.scene_description(jm), 1e-9)
    if name == "octahedron":
        assert got["geoms"][0]["type"] == "convex" and len(got["geoms"][0]["verts"]) == 6


def test_state_frame_matches_jax(models):
    name, m, jm = models
    for q in _q(m, name, 3, seed=1):
        got = state_frame(m, q, t=0.5)
        assert got["kind"] == "frame" and len(got["poses"]) == m.ngeom
        _close_json(got, jax_protocol.state_frame(jm, jnp.asarray(q.numpy()), t=0.5), 1e-5)


def test_trajectory_frames_matches_jax():
    m = _cube()
    qs = _q(m, "cube_drop", 7, seed=2)
    got = trajectory_frames(m, qs, stride=3)
    assert [f["t"] for f in got] == [0.0, 3 * 2e-3, 6 * 2e-3]
    _close_json(got, jax_protocol.trajectory_frames(jax_model_of(m), qs.numpy(), stride=3), 1e-5)


def test_scene_and_frame():
    m = _cube()
    scene = scene_description(m)
    assert scene["kind"] == "scene" and len(scene["geoms"]) == m.ngeom
    assert scene["geoms"][0]["type"] == "plane"
    q = m.neutral_q()
    q[6] = 0.5
    f = state_frame(m, q)
    np.testing.assert_allclose(f["poses"][1]["pos"], [0, 0, 0.5], atol=1e-4)


def test_save_html(tmp_path):
    m = _cube()
    q0 = m.neutral_q()
    q0[6] = 0.3
    _, traj = S.rollout(m, State(q=q0[None], v=torch.zeros(1, m.nv, dtype=F64)),
                        torch.zeros(50, 1, m.nv, dtype=F64))
    path = save_html(m, traj.q[:, 0], str(tmp_path / "replay.html"), stride=5)
    html = open(path).read()
    assert '"kind": "frame"' in html and "<canvas" in html
    assert html.count('"kind": "frame"') == 10


class TestWebsocketServer:
    def test_http_serves_page(self):
        srv = GUIWebsocketServer().serve(port=0, host="127.0.0.1")
        try:
            c = socket.create_connection(("127.0.0.1", srv.port), timeout=5)
            c.sendall(b"GET / HTTP/1.1\r\nHost: x\r\n\r\n")
            data = b""
            while b"</html>" not in data:
                chunk = c.recv(65536)
                if not chunk:
                    break
                data += chunk
            assert b"200 OK" in data
            assert b"diffdart_tpu_torch viewer" in data
            c.close()
        finally:
            srv.stop()

    def test_websocket_stream(self):
        m = _cube()
        srv = GUIWebsocketServer().serve(port=0, host="127.0.0.1")
        try:
            c = socket.create_connection(("127.0.0.1", srv.port), timeout=5)
            key = base64.b64encode(os.urandom(16)).decode()
            c.sendall((
                "GET / HTTP/1.1\r\nHost: x\r\nUpgrade: websocket\r\n"
                "Connection: Upgrade\r\n"
                f"Sec-WebSocket-Key: {key}\r\nSec-WebSocket-Version: 13\r\n\r\n").encode())
            resp = c.recv(4096)
            assert b"101" in resp
            expect = base64.b64encode(
                hashlib.sha1((key + "258EAFA5-E914-47DA-95CA-C5AB0DC85B11").encode()).digest())
            assert expect in resp
            time.sleep(0.1)
            q = m.neutral_q()
            q[6] = 0.42
            srv.renderWorld(m, q, t=0.0)
            msgs = _read_ws_messages(c, 2)
            assert [json.loads(p)["kind"] for p in msgs] == ["scene", "frame"]
            np.testing.assert_allclose(json.loads(msgs[1])["poses"][1]["pos"][2], 0.42, atol=1e-4)
            c.close()
        finally:
            srv.stop()


def _read_ws_messages(sock, n, timeout=5.0):
    sock.settimeout(timeout)
    buf = b""
    out = []
    while len(out) < n:
        buf += sock.recv(65536)
        while len(buf) >= 2:
            ln = buf[1] & 0x7F
            off = 2
            if ln == 126:
                ln = struct.unpack("!H", buf[2:4])[0]
                off = 4
            elif ln == 127:
                ln = struct.unpack("!Q", buf[2:10])[0]
                off = 10
            if len(buf) < off + ln:
                break
            out.append(buf[off:off + ln].decode())
            buf = buf[off + ln:]
    return out


def _ws_handshake(port):
    c = socket.create_connection(("127.0.0.1", port), timeout=5)
    key = base64.b64encode(os.urandom(16)).decode()
    c.sendall((
        "GET / HTTP/1.1\r\nHost: x\r\nUpgrade: websocket\r\n"
        "Connection: Upgrade\r\n"
        f"Sec-WebSocket-Key: {key}\r\nSec-WebSocket-Version: 13\r\n\r\n").encode())
    assert b"101" in c.recv(4096)
    return c


def _ws_send_text(sock, payload: str):
    """Client->server frame (masked, per RFC 6455)."""
    data = payload.encode()
    mask = os.urandom(4)
    masked = bytes(b ^ mask[i % 4] for i, b in enumerate(data))
    n = len(data)
    if n < 126:
        header = struct.pack("!BB", 0x81, 0x80 | n)
    else:
        header = struct.pack("!BBH", 0x81, 0x80 | 126, n)
    sock.sendall(header + mask + masked)


def _wait_for(xs):
    for _ in range(250):
        if xs:
            return
        time.sleep(0.02)


class TestInteraction:
    def test_drag_roundtrip_changes_sim_state(self):
        """Client drag message -> listener and consume_drag_forces (a tensor
        on the model's device) -> applied as a generalized force that
        changes the next sim state."""
        m = _cube()
        srv = GUIWebsocketServer().serve(port=0, host="127.0.0.1")
        got = []
        srv.registerDragListener(lambda body, force: got.append((body, force)))
        try:
            c = _ws_handshake(srv.port)
            _ws_send_text(c, json.dumps({"type": "drag", "body": 0, "force": [5.0, 0.0, 0.0]}))
            _wait_for(got)
            assert got and got[0][0] == 0 and got[0][1][0] == 5.0
            f = srv.consume_drag_forces(m)
            assert f.shape == (m.nbody, 3) and f.dtype == m.dtype and f.device == m.device
            np.testing.assert_allclose(f[0].numpy(), [5.0, 0.0, 0.0])
            assert srv.consume_drag_forces(m)[0][0] == 0.0  # one-shot

            q = m.neutral_q()
            q[6] = 0.1
            s = State(q=q[None], v=torch.zeros(1, m.nv, dtype=F64))
            tau = torch.zeros(1, m.nv, dtype=F64)
            tau[0, 3] = f[0, 0]  # free-joint x
            pushed, plain = S.step(m, s, tau), S.step(m, s)
            assert float(pushed.v[0, 3]) > float(plain.v[0, 3]) + 1e-6
            c.close()
        finally:
            srv.stop()

    def test_keydown_listener(self):
        srv = GUIWebsocketServer().serve(port=0, host="127.0.0.1")
        keys = []
        srv.registerKeydownListener(keys.append)
        try:
            c = _ws_handshake(srv.port)
            _ws_send_text(c, json.dumps({"type": "key", "key": "w"}))
            _wait_for(keys)
            assert keys == ["w"]
            c.close()
        finally:
            srv.stop()

    def test_render_trajectory_broadcast(self):
        m = _cube()
        srv = GUIWebsocketServer().serve(port=0, host="127.0.0.1")
        conns = []
        srv.registerConnectionListener(lambda: conns.append(1))
        try:
            c = _ws_handshake(srv.port)
            _wait_for(conns)
            qs = m.neutral_q().repeat(2, 1)
            qs[1, 6] = 0.4
            srv.renderTrajectory(m, qs, tag="iterate_3")
            msgs = _read_ws_messages(c, 2)
            assert [json.loads(p)["kind"] for p in msgs] == ["scene", "trajectory"]
            traj = json.loads(msgs[1])
            assert traj["tag"] == "iterate_3" and len(traj["frames"]) == 2
            np.testing.assert_allclose(traj["frames"][1][1]["pos"][2], 0.4, atol=1e-4)
            c.close()
        finally:
            srv.stop()
