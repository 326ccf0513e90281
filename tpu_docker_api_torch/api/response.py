"""Uniform JSON envelope ``{code, msg, data}`` (parity: reference
``internal/api/response.go:9-29`` — always HTTP 200; the app code carries the
outcome). The port's copy of ``tpu_docker_api/api/response.py``."""

from __future__ import annotations

import json
from typing import Any

from tpu_docker_api_torch.api import codes


def success(data: Any = None, stale: dict | None = None) -> bytes:
    """``stale`` defaults to None — the plain success shape. During a store
    outage the HTTP layer attaches ``{"lagMs": ...}`` so a read served from
    the informer mirror (service/store_health.py) is EXPLICITLY marked: the
    caller learns both that the answer is cached and how far behind the
    dead store's last proven instant it may be."""
    body = {"code": codes.SUCCESS, "msg": codes.message(codes.SUCCESS),
            "data": data}
    if stale is not None:
        body["stale"] = stale
    return json.dumps(body).encode()


def error(code: int, msg: str = "", data: Any = None,
          request_id: str = "") -> bytes:
    """``data`` defaults to None — the legacy error shape byte-for-byte;
    typed errors may attach structured context (errors.ApiError.data).
    ``request_id`` (the HTTP layer passes its X-Request-Id) is echoed as
    ``requestId`` so a user-reported failure is greppable in traces and
    events; empty keeps the legacy three-key envelope exactly."""
    body = {"code": code, "msg": msg or codes.message(code), "data": data}
    if request_id:
        body["requestId"] = request_id
    return json.dumps(body).encode()
