"""SIBR remote-viewer wire protocol (network_gui parity).

Port of ``riggs_tpu/viz/sibr.py``, byte for byte on the wire:

  client -> server   4-byte little-endian length, then a JSON message with
                     resolution_x/y, train, fov_x/y, z_near/z_far,
                     shs_python, rot_scale_python, keep_alive,
                     scaling_modifier, view_matrix (16 floats),
                     view_projection_matrix (16 floats)
  server -> client   raw H*W*3 uint8 image bytes, then 4-byte little-endian
                     length + ascii verify string (the dataset source path)

The server never blocks on ``accept``: ``try_connect`` polls it every
training iteration, and ``poll`` drains requests while a client is
connected (receive a camera, render, reply), returning to training when the
client asks for it. Unlike the reference, ``poll`` drops the client only on
a socket or protocol error (a closed connection, an oversized length, a
message that is not the protocol's JSON); an error of the render itself
propagates, so a kernel that fails is not mistaken for a client that left.
"""
from __future__ import annotations

import json
import socket
from typing import Callable, Optional

import numpy as np
import torch

from riggs_tpu_torch.camera.camera import Camera, fov2focal
from riggs_tpu_torch.device import resolve_device

MAX_MESSAGE = 1 << 20  # a camera message is a few hundred bytes


class ProtocolError(Exception):
    """A request that does not follow the network_gui protocol."""


def camera_from_message(msg: dict, device: str | torch.device | None = None) -> Optional[Camera]:
    """A Camera on ``device`` (the card unless given) from a SIBR viewer
    message, or None for a zero resolution. The client sends row-vector
    matrices (w2c^T) with the Y/Z columns negated, so w2c = (M with columns
    1, 2 negated)^T."""
    width = int(msg["resolution_x"])
    height = int(msg["resolution_y"])
    if width == 0 or height == 0:
        return None
    dev = resolve_device(device)
    m = np.asarray(msg["view_matrix"], np.float32).reshape(4, 4)
    m[:, 1] = -m[:, 1]
    m[:, 2] = -m[:, 2]
    w2c = np.ascontiguousarray(m.T)
    fovx, fovy = float(msg["fov_x"]), float(msg["fov_y"])
    intr = np.array([fov2focal(fovx, width), fov2focal(fovy, height), width / 2.0, height / 2.0], np.float32)
    return Camera(
        w2c=torch.as_tensor(w2c, device=dev),
        intrinsics=torch.as_tensor(intr, device=dev),
        fid=torch.zeros((), dtype=torch.float32, device=dev),
        width=width,
        height=height,
        znear=float(msg.get("z_near", 0.01)),
        zfar=float(msg.get("z_far", 100.0)),
    )


def quantize(img) -> np.ndarray:
    """float [0, 1] (H, W, 3) -> uint8 on the host: x * 255 clipped to [0,
    255], truncated (numpy's ``astype``); a tensor is quantized on its
    device and read once."""
    if isinstance(img, torch.Tensor):
        return torch.clamp(img.detach() * 255.0, 0.0, 255.0).to(torch.uint8).cpu().numpy()
    return np.clip(np.asarray(img) * 255.0, 0.0, 255.0).astype(np.uint8)


def encode_image(img) -> bytes:
    """float [0, 1] (H, W, 3) -> the raw uint8 byte stream the client expects."""
    return np.ascontiguousarray(quantize(img)).tobytes()


class SibrServer:
    """Non-blocking SIBR viewer endpoint for a training loop; cameras are
    made on ``device`` (the card unless given)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 6009, verify: str = ".",
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.verify = verify
        self.conn: Optional[socket.socket] = None
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind((host, port))
        self.listener.listen()
        self.listener.settimeout(0)  # accept never blocks

    @property
    def port(self) -> int:
        return self.listener.getsockname()[1]

    def try_connect(self) -> None:
        if self.conn is not None:
            return
        try:
            conn, _ = self.listener.accept()
            conn.settimeout(None)
            self.conn = conn
        except (BlockingIOError, socket.timeout, OSError):
            pass

    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.conn.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("SIBR client closed")
            buf += chunk
        return buf

    def receive(self) -> dict:
        n = int.from_bytes(self._recv_exact(4), "little")
        if n > MAX_MESSAGE:
            raise ProtocolError(f"message length {n} exceeds {MAX_MESSAGE}")
        msg = json.loads(self._recv_exact(n).decode("utf-8"))
        if not isinstance(msg, dict):
            raise ProtocolError("the message is not a JSON object")
        return msg

    def send(self, image_bytes: Optional[bytes]) -> None:
        if image_bytes is not None:
            self.conn.sendall(image_bytes)
        self.conn.sendall(len(self.verify).to_bytes(4, "little"))
        self.conn.sendall(bytes(self.verify, "ascii"))

    def _drop(self) -> None:
        try:
            self.conn.close()
        except OSError:
            pass
        self.conn = None

    def poll(self, render_fn: Callable[[Camera, float], "torch.Tensor | np.ndarray"],
             training_done: bool = False) -> None:
        """One training iteration's service pass.

        ``render_fn(cam, scaling_modifier)`` returns a float [0, 1] (H, W, 3)
        image. Drains viewer requests until the client asks training to
        continue (``train``) or disconnects; a ``keep_alive`` request also
        returns control unless training has finished."""
        self.try_connect()
        while self.conn is not None:
            try:
                msg = self.receive()
                cam = camera_from_message(msg, self.device)
                scaling = float(msg.get("scaling_modifier", 1.0))
            except (OSError, ProtocolError, ValueError, KeyError, TypeError):
                # a closed or broken connection, or a message that is not the
                # protocol's (JSONDecodeError and UnicodeDecodeError are
                # ValueErrors): drop the client
                self._drop()
                continue
            img_bytes = None if cam is None else encode_image(render_fn(cam, scaling))
            try:
                self.send(img_bytes)
            except OSError:
                self._drop()
                continue
            if bool(msg.get("train", False)) and not training_done:
                break
            if not bool(msg.get("keep_alive", True)) and training_done:
                break

    def close(self) -> None:
        if self.conn is not None:
            self.conn.close()
            self.conn = None
        self.listener.close()


class SibrClient:
    """A minimal protocol client (what SIBR_remoteGaussian_app sends)."""

    def __init__(self, host: str, port: int):
        self.sock = socket.create_connection((host, port))

    def request(
        self,
        width: int,
        height: int,
        view_matrix,
        fovx: float = 0.9,
        fovy: float = 0.9,
        train: bool = True,
        keep_alive: bool = True,
        scaling_modifier: float = 1.0,
    ) -> tuple[np.ndarray, str]:
        msg = dict(
            resolution_x=width,
            resolution_y=height,
            train=train,
            fov_y=fovy,
            fov_x=fovx,
            z_near=0.01,
            z_far=100.0,
            shs_python=False,
            rot_scale_python=False,
            keep_alive=keep_alive,
            scaling_modifier=scaling_modifier,
            view_matrix=list(map(float, np.asarray(view_matrix).reshape(-1))),
            view_projection_matrix=list(map(float, np.asarray(view_matrix).reshape(-1))),
        )
        payload = json.dumps(msg).encode("utf-8")
        self.sock.sendall(len(payload).to_bytes(4, "little") + payload)
        img = self._recv_exact(width * height * 3)
        n = int.from_bytes(self._recv_exact(4), "little")
        verify = self._recv_exact(n).decode("ascii")
        return np.frombuffer(img, np.uint8).reshape(height, width, 3), verify

    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("server closed")
            buf += chunk
        return buf

    def close(self) -> None:
        self.sock.close()
