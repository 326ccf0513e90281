"""Rev-anchored pagination for the list endpoints.

A list at O(100k) objects must not haul the whole keyspace per request:
every list endpoint takes ``limit`` + an opaque ``continue`` token and
walks the store in bounded pages through ``KV.range_prefix_page``
(state/kv.py). The token pins the walk to the FIRST page's store
revision, so the page sequence is one consistent snapshot — a concurrent
insert/delete under the prefix makes the next page fail with the typed
:class:`errors.ContinueExpired` (HTTP 410, the Kubernetes list contract)
instead of silently duplicating or skipping keys.

Family listing folds the raw key page into one entry per resource family
(the ``.../<base>/latest`` pointer row): the pointer's VALUE is the
latest version number, so a page of families costs zero extra reads and
zero spec deserialization. ``limit`` therefore bounds RAW KEYS SCANNED
(pointer rows + their version records interleave under one prefix); with
the retention compactor bounding history (service/compactor.py), a page
yields at least ``limit / (retention + 1)`` families.

The port's copy of ``tpu_docker_api/state/pager.py``.
"""

from __future__ import annotations

import base64
import binascii
import json

from tpu_docker_api_torch import errors
from tpu_docker_api_torch.state import keys
from tpu_docker_api_torch.state.keys import Resource
from tpu_docker_api_torch.state.kv import KV


def encode_token(resource: Resource, rev: int, last: str) -> str:
    """Opaque continue token: the anchor revision + the last RAW key the
    previous page consumed (resource included so a token cannot be
    replayed against a different endpoint)."""
    raw = json.dumps({"res": resource.value, "rev": rev, "last": last},
                     sort_keys=True)
    return base64.urlsafe_b64encode(raw.encode()).decode().rstrip("=")


def decode_token(token: str, resource: Resource) -> tuple[int, str]:
    """(anchor rev, last raw key). Garbage ⇒ BadRequest (the client
    corrupted it); a well-formed token for another resource ⇒ BadRequest
    too — neither is the 410 retry-from-scratch signal."""
    try:
        pad = "=" * (-len(token) % 4)
        d = json.loads(base64.urlsafe_b64decode(token + pad))
        rev, last, res = int(d["rev"]), str(d["last"]), str(d["res"])
    except (ValueError, KeyError, TypeError, binascii.Error) as e:
        raise errors.BadRequest(f"malformed continue token: "
                                f"{type(e).__name__}") from None
    if res != resource.value:
        raise errors.BadRequest(
            f"continue token is for {res!r}, not {resource.value!r}")
    if rev <= 0:
        raise errors.BadRequest("malformed continue token: bad rev")
    return rev, last


def _fold_families(resource: Resource, page: dict[str, str]) -> list[dict]:
    """One entry per ``/latest`` pointer row in the raw page; version
    records ride along unparsed (their values are never JSON-decoded)."""
    prefix = f"{keys.PREFIX}/{resource.value}/"
    items = []
    for k, v in page.items():
        rest = k[len(prefix):].split("/")
        if len(rest) == 2 and rest[1] == "latest":
            try:
                items.append({"name": rest[0], "version": int(v)})
            except ValueError:  # foreign junk under the prefix: skip, not 500
                continue
    return items


def list_families(kv: KV, resource: Resource, limit: int = 0,
                  token: str = "") -> dict:
    """One list page: ``{"items": [{name, version}], "continue": str|None,
    "rev": int}``. ``limit <= 0`` without a token is the legacy full scan
    (one consistent ``range_prefix_with_rev`` snapshot, no token)."""
    prefix = f"{keys.PREFIX}/{resource.value}/"
    if limit <= 0 and not token:
        snap, rev = kv.range_prefix_with_rev(prefix)
        return {"items": _fold_families(resource, snap),
                "continue": None, "rev": rev}
    if limit <= 0:
        raise errors.BadRequest("continue requires a positive limit")
    at_rev, last = decode_token(token, resource) if token else (0, "")
    page, rev = kv.range_prefix_page(prefix, limit, start_after=last,
                                     at_rev=at_rev)
    nxt = None
    if len(page) == limit:
        nxt = encode_token(resource, rev, max(page))
    return {"items": _fold_families(resource, page),
            "continue": nxt, "rev": rev}
