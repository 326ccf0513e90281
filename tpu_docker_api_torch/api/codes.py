"""Response codes.

Parity: reference ``internal/api/code.go`` — app-level codes carried in a
uniform envelope with HTTP 200 (their messages are Chinese; ours English).
Codes live on the exception classes in ``tpu_docker_api_torch.errors``; this module
adds the non-error codes and the fallback messages.

The port's copy of ``tpu_docker_api/api/codes.py``: the same codes, plus
``NOT_PORTED``, the refusal of a route whose service the port lacks
(``api/app.py`` ``NotPorted``).
"""

from __future__ import annotations

SUCCESS = 200
SERVER_ERROR = 500
BAD_REQUEST = 10001
NOT_PORTED = 10002

MESSAGES: dict[int, str] = {
    SUCCESS: "success",
    SERVER_ERROR: "internal server error",
    BAD_REQUEST: "bad request",
    NOT_PORTED: "not ported to tpu_docker_api_torch yet",
    10201: "no patch required",
    10202: "version does not match the latest",
    10301: "container already exists",
    10302: "container does not exist",
    10401: "volume already exists",
    10402: "volume does not exist",
    10403: "bytes in use exceed the requested size",
    10501: "not found in state store",
    10502: "state store unavailable",
    10503: "guarded write lost its compare",
    10506: "state store degraded; mutations held until it heals",
    10601: "not enough free GPUs",
    10602: "not enough free host ports",
    10603: "unknown GPU topology",
    10701: "host engine unreachable",
    10801: "work queue saturated; retry later",
    10802: "work queue closed",
    10901: "not the leader; send mutations to the lease holder",
}


def message(code: int) -> str:
    return MESSAGES.get(code, "unknown error")
