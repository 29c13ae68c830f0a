"""The viewer: scene and frame JSON, an HTML replay file and a live
WebSocket server. Counterpart of diffdart_tpu/viewer/."""
from diffdart_tpu_torch.viewer.protocol import scene_description, state_frame, trajectory_frames  # noqa: F401
from diffdart_tpu_torch.viewer.export import save_html  # noqa: F401
from diffdart_tpu_torch.viewer.server import GUIWebsocketServer  # noqa: F401
