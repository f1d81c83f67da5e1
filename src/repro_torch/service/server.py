"""Unix-socket JSON-lines front end for :class:`SchedulerService`.

Protocol: one JSON object per line in each direction.  Requests carry a
``cmd`` plus command-specific fields; responses are ``{"ok": true, ...}``
or ``{"ok": false, "error": "..."}`` (the error string is the service's
exception message — which, per the engine contract, names the sim time,
the job id, and the remedy).

The server is **single-threaded** (a ``selectors`` loop): ops are applied
and logged in one frame, which is what lets a checkpoint never observe a
half-applied op.  Between socket events the loop runs the service's idle
tick (advancing the replay clock and the checkpoint cadence).

Commands
--------
``ping`` · ``submit`` (job fields; see ``submit_request``) · ``cancel``
(``job_id``) · ``reconfigure`` (``config``, optional ``device``) ·
``status`` (optional ``job_id``) · ``checkpoint`` · ``close`` (drains;
returns the final result) · ``result`` · ``shutdown`` (checkpoint + exit).
"""

from __future__ import annotations

import json
import os
import selectors
import socket
from pathlib import Path
from typing import Any, Dict, Optional, Union

from repro_torch.service.service import SchedulerService, sim_result_to_dict

__all__ = ["ServiceServer", "ServiceClient", "wait_for_socket"]


class ServiceServer:
    """Serve one :class:`SchedulerService` over a unix socket."""

    def __init__(
        self,
        service: SchedulerService,
        socket_path: Union[str, Path],
        *,
        tick_interval_s: float = 0.05,
    ) -> None:
        self.service = service
        self.socket_path = Path(socket_path)
        self.tick_interval_s = tick_interval_s
        self._stop = False

    # -- request handling ------------------------------------------------

    def handle(self, req: Dict[str, Any]) -> Dict[str, Any]:
        """Dispatch one request dict; never raises (errors are responses)."""
        try:
            return {"ok": True, **self._dispatch(req)}
        except Exception as e:  # noqa: BLE001 — every service error is a reply
            return {"ok": False, "error": f"{type(e).__name__}: {e}"}

    def _dispatch(self, req: Dict[str, Any]) -> Dict[str, Any]:
        cmd = req.get("cmd")
        svc = self.service
        if cmd == "ping":
            return {"pong": True, "t": svc.applied_until}
        if cmd == "submit":
            fields = {k: v for k, v in req.items() if k != "cmd"}
            return svc.submit_request(fields)
        if cmd == "cancel":
            return svc.cancel(int(req["job_id"]))
        if cmd == "reconfigure":
            return svc.reconfigure(int(req["config"]), int(req.get("device", 0)))
        if cmd == "status":
            return {"status": svc.status(req.get("job_id"))}
        if cmd == "checkpoint":
            return {"checkpoint": str(svc.checkpoint())}
        if cmd == "close":
            svc.close()
            return {"result": sim_result_to_dict(svc.result())}
        if cmd == "result":
            return {"result": sim_result_to_dict(svc.result())}
        if cmd == "shutdown":
            self._stop = True
            return {"stopping": True}
        raise ValueError(
            f"unknown command {cmd!r}; valid: ping, submit, cancel, "
            f"reconfigure, status, checkpoint, close, result, shutdown"
        )

    # -- event loop ------------------------------------------------------

    def serve_forever(self) -> None:
        """Accept clients until a ``shutdown`` request arrives.

        On exit the service is checkpointed and the socket removed; a
        SIGKILL skips all of that — which is exactly the crash the WAL
        protocol recovers from.
        """
        if self.socket_path.exists():
            self.socket_path.unlink()
        sel = selectors.DefaultSelector()
        srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        srv.bind(str(self.socket_path))
        srv.listen(64)
        srv.setblocking(False)
        sel.register(srv, selectors.EVENT_READ, data=None)
        buffers: Dict[socket.socket, bytes] = {}
        try:
            while not self._stop:
                for key, _ in sel.select(timeout=self.tick_interval_s):
                    if key.data is None:
                        conn, _ = srv.accept()
                        conn.setblocking(False)
                        buffers[conn] = b""
                        sel.register(conn, selectors.EVENT_READ, data="conn")
                        continue
                    conn = key.fileobj
                    try:
                        chunk = conn.recv(65536)
                    except ConnectionError:
                        chunk = b""
                    if not chunk:
                        sel.unregister(conn)
                        conn.close()
                        buffers.pop(conn, None)
                        continue
                    buffers[conn] += chunk
                    while b"\n" in buffers[conn]:
                        line, buffers[conn] = buffers[conn].split(b"\n", 1)
                        if not line.strip():
                            continue
                        try:
                            req = json.loads(line)
                        except json.JSONDecodeError as e:
                            resp = {"ok": False, "error": f"bad JSON: {e}"}
                        else:
                            resp = self.handle(req)
                        conn.sendall(
                            json.dumps(resp, sort_keys=True).encode() + b"\n"
                        )
                        if self._stop:
                            break
                self.service.tick()
        finally:
            for conn in list(buffers):
                conn.close()
            sel.close()
            srv.close()
            if self.socket_path.exists():
                self.socket_path.unlink()
            self.service.shutdown()


class ServiceClient:
    """Line-oriented client for :class:`ServiceServer` (CLI + load tests)."""

    def __init__(self, socket_path: Union[str, Path], timeout: float = 30.0) -> None:
        self.socket_path = str(socket_path)
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.settimeout(timeout)
        self._sock.connect(self.socket_path)
        self._buf = b""

    def request(self, req: Dict[str, Any]) -> Dict[str, Any]:
        """Send one request and block for its response line.

        Raises :class:`RuntimeError` with the server's error message when
        the response carries ``ok=False``.
        """
        self._sock.sendall(json.dumps(req).encode() + b"\n")
        while b"\n" not in self._buf:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise ConnectionError("server closed the connection")
            self._buf += chunk
        line, self._buf = self._buf.split(b"\n", 1)
        resp = json.loads(line)
        if not resp.get("ok"):
            raise RuntimeError(resp.get("error", "unknown server error"))
        return resp

    # convenience wrappers ------------------------------------------------

    def ping(self) -> Dict[str, Any]:
        return self.request({"cmd": "ping"})

    def submit(self, **fields: Any) -> Dict[str, Any]:
        return self.request({"cmd": "submit", **fields})

    def cancel(self, job_id: int) -> Dict[str, Any]:
        return self.request({"cmd": "cancel", "job_id": job_id})

    def reconfigure(self, config: int, device: int = 0) -> Dict[str, Any]:
        return self.request(
            {"cmd": "reconfigure", "config": config, "device": device}
        )

    def status(self, job_id: Optional[int] = None) -> Dict[str, Any]:
        req: Dict[str, Any] = {"cmd": "status"}
        if job_id is not None:
            req["job_id"] = job_id
        return self.request(req)["status"]

    def close_stream(self) -> Dict[str, Any]:
        return self.request({"cmd": "close"})["result"]

    def result(self) -> Dict[str, Any]:
        return self.request({"cmd": "result"})["result"]

    def checkpoint(self) -> str:
        return self.request({"cmd": "checkpoint"})["checkpoint"]

    def shutdown(self) -> Dict[str, Any]:
        return self.request({"cmd": "shutdown"})

    def close(self) -> None:
        self._sock.close()


def wait_for_socket(path: Union[str, Path], timeout_s: float = 10.0) -> None:
    """Block until a server socket exists and accepts (test/bench helper)."""
    import time

    deadline = time.monotonic() + timeout_s  # lint: waive[DT002] test-helper poll deadline
    last: Optional[Exception] = None
    while time.monotonic() < deadline:  # lint: waive[DT002] test-helper poll loop
        if os.path.exists(path):
            try:
                ServiceClient(path, timeout=2.0).close()
                return
            except OSError as e:
                last = e
        time.sleep(0.02)
    raise TimeoutError(f"no server on {path} after {timeout_s}s: {last}")
