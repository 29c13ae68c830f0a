"""Live WebSocket GUI server, standard library only (no websockets package).

Counterpart of diffdart_tpu/viewer/server.py (server::GUIWebsocketServer
parity: serve(port), renderWorld): serves the viewer page over HTTP and
streams scene and frame JSON over a hand-rolled RFC 6455 WebSocket (text
frames, no extensions). Runs in a background thread; `renderWorld(model,
q)` takes q on any device and does not block on the clients.
"""
from __future__ import annotations

import base64
import hashlib
import json
import socket
import struct
import threading

import torch

from diffdart_tpu_torch.viewer.client import build_page
from diffdart_tpu_torch.viewer.protocol import scene_description, state_frame, trajectory_frames

_WS_MAGIC = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"


def _ws_accept_key(key: str) -> str:
    return base64.b64encode(hashlib.sha1((key + _WS_MAGIC).encode()).digest()).decode()


def _ws_frame(payload: bytes) -> bytes:
    """Server->client text frame (FIN, opcode 1, unmasked)."""
    n = len(payload)
    if n < 126:
        header = struct.pack("!BB", 0x81, n)
    elif n < 1 << 16:
        header = struct.pack("!BBH", 0x81, 126, n)
    else:
        header = struct.pack("!BBQ", 0x81, 127, n)
    return header + payload


def _recv_exact(conn: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            raise OSError("socket closed")
        buf += chunk
    return buf


def _ws_read_frame(conn: socket.socket):
    """Read one client->server frame (RFC6455: client frames are masked).
    Returns (opcode, payload) or (None, b'') on close."""
    h = _recv_exact(conn, 2)
    opcode = h[0] & 0x0F
    masked = h[1] & 0x80
    n = h[1] & 0x7F
    if n == 126:
        (n,) = struct.unpack("!H", _recv_exact(conn, 2))
    elif n == 127:
        (n,) = struct.unpack("!Q", _recv_exact(conn, 8))
    mask = _recv_exact(conn, 4) if masked else b"\x00" * 4
    data = _recv_exact(conn, n)
    payload = bytes(b ^ mask[i % 4] for i, b in enumerate(data))
    if opcode == 0x8:  # close
        return None, b""
    return opcode, payload


class GUIWebsocketServer:
    """serve(port) then renderWorld(model, q) each step (or as often as you
    like); browsers at http://host:port see the live world."""

    def __init__(self):
        self._clients: list[socket.socket] = []
        self._lock = threading.Lock()
        self._scene_msg: bytes | None = None
        self._model = None
        self._srv: socket.socket | None = None
        self._thread: threading.Thread | None = None
        self._running = False
        self.port = None
        # interaction (reference GUIWebsocketServer::registerDragListener /
        # registerKeydownListener / registerConnectionListener parity)
        self._drag_listeners: list = []
        self._key_listeners: list = []
        self._conn_listeners: list = []
        self._forces: dict[int, list] = {}  # body -> world force, via drags

    # -- public API (reference GUIWebsocketServer parity) -------------------
    def serve(self, port: int = 8070, host: str = "127.0.0.1"):
        # loopback by default: this is an unauthenticated dev server; pass
        # host="0.0.0.0" explicitly to expose it beyond the local machine
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(8)
        self.port = self._srv.getsockname()[1]
        self._running = True
        self._thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._running = False
        if self._srv is not None:
            try:
                self._srv.close()
            except OSError:
                pass
        with self._lock:
            for c in self._clients:
                try:
                    c.close()
                except OSError:
                    pass
            self._clients.clear()

    def renderWorld(self, model, q, t=0.0):
        """Send the current world state to all connected clients."""
        if model is not self._model:
            self._model = model
            self._scene_msg = _ws_frame(json.dumps(scene_description(model)).encode())
            self._broadcast(self._scene_msg)
        frame = _ws_frame(json.dumps(state_frame(model, q, t)).encode())
        self._broadcast(frame)

    def renderTrajectory(self, model, qs, tag="trajectory"):
        """Stream a whole trajectory (e.g. the optimizer's current iterate —
        Problem::registerIntermediateCallback parity): clients ghost-render
        it behind the live state."""
        if model is not self._model:
            self._model = model
            self._scene_msg = _ws_frame(json.dumps(scene_description(model)).encode())
            self._broadcast(self._scene_msg)
        msg = {
            "kind": "trajectory",
            "tag": tag,
            "frames": [f["poses"] for f in trajectory_frames(model, qs)],
        }
        self._broadcast(_ws_frame(json.dumps(msg).encode()))

    # -- interaction (client -> server) --------------------------------------
    def registerDragListener(self, fn):
        """fn(body: int, force_xyz: list[float]) on every drag message."""
        self._drag_listeners.append(fn)

    def registerKeydownListener(self, fn):
        """fn(key: str) on every keydown message."""
        self._key_listeners.append(fn)

    def registerConnectionListener(self, fn):
        """fn() when a websocket client completes its handshake."""
        self._conn_listeners.append(fn)

    def consume_drag_forces(self, model):
        """Drain accumulated drag forces into a (nbody, 3) world-force tensor
        on the model's device, in its dtype, for the sim loop (poll once per
        step; forces are one-shot impulses scaled by the client)."""
        out = torch.zeros(model.nbody, 3, dtype=torch.float64)
        with self._lock:
            for body, f in self._forces.items():
                if 0 <= body < model.nbody:
                    out[body] = torch.tensor(f, dtype=torch.float64)
            self._forces.clear()
        return out.to(device=model.device, dtype=model.dtype)

    def _on_message(self, payload: bytes):
        try:
            msg = json.loads(payload.decode())
        except (ValueError, UnicodeDecodeError):
            return
        mtype = msg.get("type")
        if mtype == "drag":
            body = int(msg.get("body", -1))
            force = [float(x) for x in msg.get("force", (0, 0, 0))][:3]
            with self._lock:
                self._forces[body] = force
            for fn in self._drag_listeners:
                fn(body, force)
        elif mtype == "key":
            for fn in self._key_listeners:
                fn(str(msg.get("key", "")))

    # -- internals ----------------------------------------------------------
    def _broadcast(self, data: bytes):
        dead = []
        with self._lock:
            for c in self._clients:
                try:
                    c.sendall(data)
                except OSError:
                    dead.append(c)
            for c in dead:
                self._clients.remove(c)

    def _accept_loop(self):
        while self._running:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            threading.Thread(target=self._handle, args=(conn,), daemon=True).start()

    def _handle(self, conn: socket.socket):
        try:
            req = conn.recv(8192).decode("latin1")
        except OSError:
            return
        headers = {}
        for line in req.split("\r\n")[1:]:
            if ":" in line:
                k, v = line.split(":", 1)
                headers[k.strip().lower()] = v.strip()
        if headers.get("upgrade", "").lower() == "websocket":
            key = headers.get("sec-websocket-key", "")
            resp = (
                "HTTP/1.1 101 Switching Protocols\r\n"
                "Upgrade: websocket\r\nConnection: Upgrade\r\n"
                f"Sec-WebSocket-Accept: {_ws_accept_key(key)}\r\n\r\n"
            )
            conn.sendall(resp.encode())
            with self._lock:
                self._clients.append(conn)
            if self._scene_msg is not None:
                try:
                    conn.sendall(self._scene_msg)
                except OSError:
                    pass
            for fn in self._conn_listeners:
                fn()
            # reader loop: client -> server interaction messages
            while self._running:
                try:
                    opcode, payload = _ws_read_frame(conn)
                except OSError:
                    break
                if opcode is None:  # close frame
                    break
                if opcode == 0x9:  # ping -> pong
                    try:
                        conn.sendall(struct.pack("!BB", 0x8A, 0))
                    except OSError:
                        break
                    continue
                if opcode == 0x1:
                    self._on_message(payload)
            with self._lock:
                if conn in self._clients:
                    self._clients.remove(conn)
            try:
                conn.close()
            except OSError:
                pass
        else:
            # HTTP: serve the viewer page pointed at our own websocket
            page = build_page("null", "[]", '"ws://" + location.host + "/"').encode()
            resp = (
                "HTTP/1.1 200 OK\r\nContent-Type: text/html\r\n"
                f"Content-Length: {len(page)}\r\nConnection: close\r\n\r\n"
            ).encode() + page
            try:
                conn.sendall(resp)
            finally:
                conn.close()
