"""Socket transport: the LidarSlamNode process without ROS.

The reference's production process is a ROS node (LidarSlamNode.cxx:62-155):
it subscribes to 1..N point-cloud topics, runs the engine, and publishes
pose/odometry, confidence and map/keypoint clouds, plus a SlamCommand
topic for runtime control (:244-349). This module provides the same
*process* shape over a plain TCP socket — the transport the environment
does have — so the engine runs as a standalone service any client
language can drive:

- client -> server messages: `frame` (one sweep, binary payload),
  `command` (SlamCommand ids, LidarSlamNode.cxx:244-349 parity), `flush`
  (drain the stream), `get_map` (map cloud download), `bye`.
- server -> client: one `pose` message per processed/flushed frame
  (pose 4x4 + covariance 6x6 + confidence scalars — the odom + Confidence
  publish pair), `map` replies, `error` replies.

Wire framing: u32-LE header length, JSON header, then `nbytes` of binary
payload laid out as described by the header. Arrays are little-endian.

Usage:  python -m lidarslam_tpu_torch.cli serve --port 8342
Client: `SlamClient` below (also the test harness).

The PyTorch port's copy of `lidarslam_tpu/server.py`: the same messages,
framing and command set, around the port's `Slam` (on the CUDA device
unless the caller passes a CPU one). One engine serves every client:
each engine operation runs under `slam_lock` in its client's handler
thread, so a stream segment's CUDA graph (ops/stream_graph.py) is captured
in one client's thread and replayed from the next client's. A capture
fails if any other thread launches CUDA work while it runs, so the pose
messages are built under the lock as well (their fields are host values),
and code outside the server that shares the device must stay off it
while the server streams.
"""

from __future__ import annotations

import json
import socket
import socketserver
import struct
import threading

import numpy as np

_U32 = struct.Struct("<I")


def _send(sock, header: dict, payload: bytes = b"") -> None:
    h = json.dumps(header).encode()
    sock.sendall(_U32.pack(len(h)) + h + payload)


def _recv_exact(sock, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf.extend(chunk)
    return bytes(buf)


def _recv(sock):
    (hlen,) = _U32.unpack(_recv_exact(sock, 4))
    header = json.loads(_recv_exact(sock, hlen).decode())
    payload = _recv_exact(sock, int(header.get("nbytes", 0)))
    return header, payload


def frame_payload(frame: dict) -> tuple[dict, bytes]:
    """Encode an engine frame dict as (header, payload)."""
    xyz = np.ascontiguousarray(frame["xyz"], np.float32)
    n = len(xyz)
    inten = np.ascontiguousarray(frame["intensity"], np.float32)
    lid = np.ascontiguousarray(frame["laser_id"], np.int32)
    time = np.ascontiguousarray(frame["time"], np.float32)
    payload = xyz.tobytes() + inten.tobytes() + lid.tobytes() + time.tobytes()
    header = {"type": "frame", "stamp": float(frame["stamp"]), "n": n,
              "device_id": int(frame.get("device_id", 0)),
              "nbytes": len(payload)}
    if "seq" in frame:
        header["seq"] = int(frame["seq"])
    return header, payload


def decode_frame(header: dict, payload: bytes) -> dict:
    n = int(header["n"])
    o = 0
    xyz = np.frombuffer(payload, np.float32, 3 * n, o).reshape(n, 3)
    o += 12 * n
    inten = np.frombuffer(payload, np.float32, n, o)
    o += 4 * n
    lid = np.frombuffer(payload, np.int32, n, o)
    o += 4 * n
    time = np.frombuffer(payload, np.float32, n, o)
    out = {"xyz": xyz, "intensity": inten, "laser_id": lid, "time": time,
           "stamp": float(header["stamp"]),
           "device_id": int(header.get("device_id", 0))}
    if "seq" in header:
        out["seq"] = int(header["seq"])
    return out


def _pose_msg(out) -> dict:
    """FrameOutput -> the odom+Confidence publish pair as one message."""
    return {"type": "pose", "stamp": out.stamp, "frame_index": out.frame_index,
            "pose": np.asarray(out.pose, np.float64).ravel().tolist(),
            "covariance": np.asarray(out.covariance, np.float64).ravel().tolist(),
            "n_matches": int(out.n_matches), "overlap": float(out.overlap),
            "failure": bool(out.failure),
            "comply_motion_limits": bool(out.comply_motion_limits),
            "is_keyframe": bool(out.is_keyframe)}


# SlamCommand ids the dispatch accepts (LidarSlamNode.cxx:244-349 /
# Slam.execute_command) — used to reject unknown ids at validation time,
# before any engine state is touched
_KNOWN_COMMANDS = frozenset({0, 2, 4, 8, 9, 10, 16, 17, 18})


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):  # one client session
        slam = self.server.slam
        lock = self.server.slam_lock
        sock = self.request
        # Poses are routed per client by GLOBAL FRAME INDEX: this handler
        # registers the engine frame index each of ITS frames will get at
        # submission time (under the lock, so the index arithmetic is
        # race-free), and only collects matching outputs — a second
        # connection (e.g. a map viewer) never receives another client's
        # trajectory, identical stamps across clients cannot cross-route,
        # and tokens are discarded on delivery (bounded memory over
        # long-lived connections).
        pending = []
        my_frames = set()

        def _on_output(out):
            if out.frame_index in my_frames:
                my_frames.discard(out.frame_index)
                pending.append(out)

        unsub = slam.subscribe(_on_output)
        try:
            while True:
                try:
                    header, payload = _recv(sock)
                except ConnectionError:
                    break
                t = header.get("type")
                reply = None          # (header, payload) sent AFTER poses so
                done = False          # a client awaiting the ack sees every
                f = None              # pose of the frames the op flushed
                # request decode/validation: errors here touched no engine
                # state -> reply and keep the session alive
                try:
                    if t == "frame":
                        f = decode_frame(header, payload)
                    elif t == "command":
                        c = int(header["command"])
                        if c not in _KNOWN_COMMANDS:
                            raise ValueError(f"unknown SLAM command {c}")
                        header["command"] = c
                    elif t == "get_map":
                        from lidarslam_tpu_torch.config import Keypoint
                        kpt = Keypoint(int(header.get("keypoint", 1)))
                        if kpt not in slam.cfg.used_types:
                            raise ValueError(f"keypoint type {kpt.name} "
                                             "unused in this configuration")
                        header["keypoint"] = kpt
                    elif t not in ("flush", "bye"):
                        raise ValueError(f"unknown type {t!r}")
                except Exception as exc:
                    _send(sock, {"type": "error",
                                 "message": f"{type(exc).__name__}: {exc}"})
                    continue
                # engine ops: an exception mid-mutation (add_frame,
                # execute_command) can leave the Slam/stream state partially
                # updated — log it server-side, tell the client, and CLOSE
                # the session rather than silently serving from a possibly
                # inconsistent engine.
                try:
                    with lock:
                        if t == "frame":
                            if self.server.stream:
                                # streaming: output arrives at flush; global
                                # index = flushed frames + enqueued-this-
                                # segment (both only advance under the lock)
                                idx = slam.add_frame_async(f)
                                if idx >= 0:
                                    my_frames.add(slam.n_frames + idx)
                            else:
                                # sync: the subscriber fires inside
                                # add_frame, so register the index first and
                                # roll back if the frame was skipped
                                my_frames.add(slam.n_frames)
                                r = slam.add_frame(f)
                                if r.get("skipped"):
                                    my_frames.discard(slam.n_frames)
                        elif t == "flush":
                            slam.flush()
                            reply = ({"type": "flushed",
                                      "n_frames": int(slam.n_frames)}, b"")
                        elif t == "command":
                            slam.execute_command(header["command"],
                                                 header.get("arg", ""))
                            reply = ({"type": "ok"}, b"")
                        elif t == "get_map":
                            slam.flush()
                            pts, inten, _, _ = slam.get_map_points(
                                header["keypoint"])
                            pl = (np.asarray(pts, np.float32).tobytes()
                                  + np.asarray(inten, np.float32).tobytes())
                            reply = ({"type": "map", "n": len(pts),
                                      "nbytes": len(pl)}, pl)
                        elif t == "bye":
                            slam.flush()
                            done = True
                except Exception as exc:
                    import traceback
                    traceback.print_exc()
                    reply = ({"type": "error", "fatal": True,
                              "message": f"{type(exc).__name__}: {exc}"}, b"")
                    done = True
                # drain per-frame outputs accumulated by the subscriber
                with lock:
                    msgs = [_pose_msg(out) for out in pending]
                    pending[:] = []
                for msg in msgs:
                    _send(sock, msg)
                if reply is not None:
                    _send(sock, reply[0], reply[1])
                if done:
                    break
        finally:
            unsub()


class SlamServer(socketserver.ThreadingTCPServer):
    """One engine instance served over TCP (the LidarSlamNode process)."""

    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, slam, host="127.0.0.1", port=8342, stream=True):
        self.slam = slam
        self.slam_lock = threading.Lock()   # frames from several clients
        self.stream = stream
        super().__init__((host, port), _Handler)

    def serve_background(self):
        th = threading.Thread(target=self.serve_forever, daemon=True)
        th.start()
        return th


class SlamClient:
    """Minimal client (also the test harness)."""

    def __init__(self, host="127.0.0.1", port=8342, timeout=300.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.poses = []

    def _drain_until(self, msg_type):
        while True:
            header, payload = _recv(self.sock)
            if header["type"] == "pose":
                self.poses.append(header)
                continue
            if header["type"] == "error":
                raise RuntimeError(header.get("message"))
            if header["type"] == msg_type:
                return header, payload

    def send_frame(self, frame: dict) -> None:
        _send(self.sock, *frame_payload(frame))

    def flush(self) -> list:
        _send(self.sock, {"type": "flush"})
        self._drain_until("flushed")
        return self.poses

    def command(self, command: int, arg: str = "") -> None:
        _send(self.sock, {"type": "command", "command": int(command),
                          "arg": arg})
        self._drain_until("ok")

    def get_map(self, keypoint: int = 1):
        _send(self.sock, {"type": "get_map", "keypoint": int(keypoint)})
        header, payload = self._drain_until("map")
        n = int(header["n"])
        xyz = np.frombuffer(payload, np.float32, 3 * n).reshape(n, 3)
        inten = np.frombuffer(payload, np.float32, n, 12 * n)
        return xyz, inten

    def close(self):
        try:
            _send(self.sock, {"type": "bye"})
        except OSError:
            pass
        self.sock.close()
