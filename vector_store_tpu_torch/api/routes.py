"""REST routes of the port: the text-search surface over BM25 indexes and
the ANN surface over graph, exact and IVF indexes.

Counterpart of vector_store_tpu/api/routes.py:
    GET    /api/v1/text-search                   list text indexes
    PUT    /api/v1/text-search/{index}           create (delete, then add)
    POST   /api/v1/text-search/{index}/add       {id, text} -> 200 | 404
    POST   /api/v1/text-search/{index}/search    {text, limit} -> keys | 404 | 500
    GET    /api/v1/indexes                       list ids
    PUT    /api/v1/indexes/{ks}/{idx}            create with params body
    GET    /api/v1/indexes/{ks}/{idx}            kind, params, live count
    DELETE /api/v1/indexes/{ks}/{idx}            drop
    POST   /api/v1/indexes/{ks}/{idx}/ann        {embedding, limit} ->
           {primary_keys: {col: [...]}, distances: [...]}
    GET    /api/v1/indexes/{ks}/{idx}/count      live count
    POST   /api/v1/indexes/{ks}/{idx}/add        {primary_key, embedding}
    POST   /api/v1/indexes/{ks}/{idx}/remove     {primary_key}
    POST   /api/v1/indexes/{ks}/{idx}/compact    -> {count}
    GET    /healthz, /metrics, /api-docs/openapi.json, /swagger-ui

Kinds "ann" (the default), "exact", "ivf", "auto" and "text" are served;
any other kind answers 400 naming it.  The ANN PUT body may declare
`capacity` (IndexParams.capacity), which sizes the index and decides kind
"auto".
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import time

import numpy as np
from aiohttp import web

from ..types import IndexId, IndexMetadata, IndexParams, Limit
from ..utils import metrics
from ..utils import native as _native

from ..engine.engine import EngineHandle
from ..engine.factory import PORTED_KINDS, resolve_kind
from .openapi import openapi_spec, swagger_html

log = logging.getLogger("vst.http")

# Optional serving deadline (seconds) for query requests: a wedged device
# step surfaces as 504 instead of a connection that hangs.  0 = off.
REQUEST_TIMEOUT_S = float(os.environ.get("VST_REQUEST_TIMEOUT_S", "0"))


def native_available() -> bool:
    """Whether the native JSON body scanner loaded (else the Python parse)."""
    return _native.available()


class _DeadlineExceeded(Exception):
    """Distinct from TimeoutError, so a TimeoutError raised inside a
    handler is never mislabelled as the serving deadline."""


async def _bounded(coro):
    if REQUEST_TIMEOUT_S <= 0:
        return await coro
    try:
        return await asyncio.wait_for(coro, REQUEST_TIMEOUT_S)
    except asyncio.TimeoutError:
        raise _DeadlineExceeded from None


def _json_error(status: int, text: str = "") -> web.Response:
    return web.Response(status=status, text=text)


def _not_ported(kind: str) -> web.Response:
    return _json_error(
        400,
        f"index kind {kind!r} is not served by vector_store_tpu_torch "
        f"(served: {', '.join(PORTED_KINDS)})",
    )


async def _get_index(request: web.Request, index_id: IndexId):
    # handle cache: del_index closes the handle, so `closed` doubles as
    # the invalidation bit
    cache: dict = request.app["handle_cache"]
    h = cache.get(index_id)
    if h is not None and not h.closed:
        return h
    engine: EngineHandle = request.app["engine"]
    h = await engine.get_index(index_id)
    if h is None:
        cache.pop(index_id, None)
    else:
        cache[index_id] = h
    return h


def _index_id(request: web.Request) -> IndexId:
    if "keyspace" in request.match_info:
        return IndexId.from_parts(request.match_info["keyspace"], request.match_info["index"])
    return IndexId(request.match_info["index"])


async def _index_ids(engine: EngineHandle, text: bool) -> list[str]:
    """Ids of the text indexes, or of all the others."""
    ids = []
    for index_id in await engine.get_index_ids():
        handle = await engine.get_index(index_id)
        if handle is not None and (handle.metadata.kind == "text") == text:
            ids.append(index_id.value)
    return ids


# --------------------------------------------------------------------------
# text-search surface


async def get_text_indexes(request: web.Request) -> web.Response:
    return web.json_response(await _index_ids(request.app["engine"], text=True))


async def put_text_index(request: web.Request) -> web.Response:
    """Create an index, with recreate semantics: delete, then add
    (httproutes.rs:76-79)."""
    engine: EngineHandle = request.app["engine"]
    index_id = _index_id(request)
    await engine.del_index(index_id)
    await engine.add_index(IndexMetadata(index_id=index_id, kind="text"))
    return web.Response(status=200)


async def post_text_add(request: web.Request) -> web.Response:
    index = await _get_index(request, _index_id(request))
    if index is None:
        return _json_error(404)
    body = await request.json()
    try:
        await index.add((body["id"],), body["text"])
    except Exception as exc:  # noqa: BLE001 -- e.g. handle closed by a racing PUT
        return _json_error(500, f"index.add request error: {exc}")
    return web.Response(status=200)


async def post_text_search(request: web.Request) -> web.Response:
    index = await _get_index(request, _index_id(request))
    if index is None:
        return _json_error(404)
    body = await request.json()
    limit = Limit(int(body.get("limit", 1)))
    try:
        keys = await _bounded(index.search(body["text"], limit))
    except _DeadlineExceeded:
        return _json_error(504, "search deadline exceeded")
    except Exception as exc:  # noqa: BLE001 -- 500 with the error text
        msg = f"index.search request error: {exc}"
        log.debug("post_text_search: %s", msg)
        return _json_error(500, msg)
    # the live system's keys are plain strings (lib.rs:63): unwrap 1-tuples
    return web.json_response([k[0] if len(k) == 1 else list(k) for k in keys])


# --------------------------------------------------------------------------
# ANN surface


async def get_ann_indexes(request: web.Request) -> web.Response:
    return web.json_response(await _index_ids(request.app["engine"], text=False))


async def put_ann_index(request: web.Request) -> web.Response:
    engine: EngineHandle = request.app["engine"]
    index_id = _index_id(request)
    body = await request.json() if request.can_read_body else {}
    try:
        params = IndexParams(
            dimensions=int(body["dimensions"]),
            connectivity=int(body.get("connectivity", 32)),
            expansion_add=int(body.get("expansion_add", 128)),
            expansion_search=int(body.get("expansion_search", 64)),
            space=body.get("space", "cosine"),
            dtype=body.get("dtype", "bfloat16"),
            capacity=int(body.get("capacity", IndexParams.capacity)),
        )
    except KeyError:
        return _json_error(400, "missing required field: dimensions")
    except ValueError as exc:
        return _json_error(400, str(exc))
    if params.capacity <= 0:
        return _json_error(400, "capacity must be positive")
    kind = body.get("kind", "ann")
    if resolve_kind(kind, params) not in PORTED_KINDS:
        return _not_ported(resolve_kind(kind, params))
    key_columns = tuple(body.get("key_columns", ()))
    await engine.del_index(index_id)
    await engine.add_index(
        IndexMetadata(index_id=index_id, params=params, key_columns=key_columns, kind=kind)
    )
    return web.Response(status=200)


async def get_ann_index_info(request: web.Request) -> web.Response:
    index = await _get_index(request, _index_id(request))
    if index is None:
        return _json_error(404)
    meta = index.metadata
    params = meta.params  # None for a text index
    return web.json_response(
        {
            "id": _index_id(request).value,
            "kind": meta.kind,
            "key_columns": list(meta.key_columns or ()),
            "params": {
                "dimensions": params.dimensions,
                "connectivity": params.connectivity,
                "expansion_add": params.expansion_add,
                "expansion_search": params.expansion_search,
                "space": params.space,
                "dtype": params.dtype,
            }
            if params is not None
            else None,
            "count": await index.count(),
        }
    )


async def delete_ann_index(request: web.Request) -> web.Response:
    engine: EngineHandle = request.app["engine"]
    await engine.del_index(_index_id(request))
    return web.Response(status=200)


def _column_major(keys: list, key_columns: tuple) -> dict:
    """PostIndexAnnResponse.primary_keys shape: {column: [values]}."""
    width = max((len(k) for k in keys), default=len(key_columns) or 1)
    cols = list(key_columns) + [f"pk{i}" for i in range(len(key_columns), width)]
    return {
        col: [list(k)[i] if i < len(k) else None for k in keys]
        for i, col in enumerate(cols[:width])
    }


async def post_ann(request: web.Request) -> web.Response:
    index = await _get_index(request, _index_id(request))
    if index is None:
        return _json_error(404)
    # the native scanner parses the two fields straight off the raw body;
    # any structural surprise returns None and the full JSON parse below
    # keeps its exact error semantics
    raw = await request.read()
    embedding = _native.parse_json_floats(raw, b"embedding", 8192)
    lim = _native.parse_json_int(raw, b"limit", 1)
    if embedding is not None and len(embedding) and lim is not None and lim > 0:
        limit = Limit(lim)
    else:
        body = json.loads(raw)
        limit = Limit(int(body.get("limit", 1)))
        embedding = np.asarray(body["embedding"], dtype=np.float32)
    try:
        keys, distances = await _bounded(index.ann(embedding, limit))
    except _DeadlineExceeded:
        return _json_error(504, "ann deadline exceeded")
    except ValueError as exc:  # dimension mismatch
        return _json_error(400, str(exc))
    except Exception as exc:  # noqa: BLE001
        msg = f"index.ann request error: {exc}"
        log.debug("post_ann: %s", msg)
        return _json_error(500, msg)
    key_columns = tuple(index.metadata.key_columns or ())
    return web.json_response(
        {"primary_keys": _column_major(keys, key_columns), "distances": distances}
    )


async def get_count(request: web.Request) -> web.Response:
    index = await _get_index(request, _index_id(request))
    if index is None:
        return _json_error(404)
    try:
        return web.json_response(await index.count())
    except Exception as exc:  # noqa: BLE001 -- e.g. racing recreate
        return _json_error(500, f"index.count request error: {exc}")


def _primary_key(raw, index) -> tuple:
    """Normalise a JSON primary key (scalar, list of scalars, or object
    ordered by the index's key_columns) into a hashable tuple."""
    if isinstance(raw, dict):
        key_columns = tuple(index.metadata.key_columns or ())
        if key_columns:
            missing = [c for c in key_columns if c not in raw]
            if missing:
                raise ValueError(f"primary_key missing columns: {missing}")
            values = [raw[c] for c in key_columns]
        else:
            values = list(raw.values())
    elif isinstance(raw, list):
        values = raw
    else:
        values = [raw]
    for v in values:
        if not isinstance(v, (str, int, float, bool)) and v is not None:
            raise ValueError(
                f"primary_key values must be scalars, got {type(v).__name__}"
            )
    return tuple(values)


async def post_ann_add(request: web.Request) -> web.Response:
    index = await _get_index(request, _index_id(request))
    if index is None:
        return _json_error(404)
    body = await request.json()
    embedding = np.asarray(body["embedding"], dtype=np.float32)
    try:
        key = _primary_key(body["primary_key"], index)
        # AddOrReplace is fire-and-forget: reject a dims mismatch here,
        # while the client is still listening
        params = index.metadata.params
        if params is not None and embedding.shape != (params.dimensions,):
            dims = params.dimensions
            raise ValueError(
                f"expected embedding of {dims} dimensions, got shape {embedding.shape}"
            )
        await index.add_or_replace(key, embedding)
    except ValueError as exc:
        return _json_error(400, str(exc))
    except Exception as exc:  # noqa: BLE001 -- e.g. racing recreate
        return _json_error(500, f"index.add request error: {exc}")
    return web.Response(status=200)


async def post_ann_remove(request: web.Request) -> web.Response:
    index = await _get_index(request, _index_id(request))
    if index is None:
        return _json_error(404)
    body = await request.json()
    try:
        key = _primary_key(body["primary_key"], index)
    except ValueError as exc:
        return _json_error(400, str(exc))
    try:
        await index.remove(key)
    except Exception as exc:  # noqa: BLE001 -- e.g. racing recreate
        return _json_error(500, f"index.remove request error: {exc}")
    return web.Response(status=200)


async def post_compact(request: web.Request) -> web.Response:
    index = await _get_index(request, _index_id(request))
    if index is None:
        return _json_error(404)
    try:
        count = await index.compact()
    except Exception as exc:  # noqa: BLE001
        return _json_error(500, f"compact error: {exc}")
    return web.json_response({"count": count})


async def healthz(request: web.Request) -> web.Response:
    return web.json_response({"status": "ok"})


async def get_metrics(request: web.Request) -> web.Response:
    return web.Response(text=metrics.render(), content_type="text/plain")


async def get_openapi(request: web.Request) -> web.Response:
    return web.json_response(openapi_spec())


async def get_swagger(request: web.Request) -> web.Response:
    return web.Response(text=swagger_html(), content_type="text/html")


@web.middleware
async def _metrics_middleware(request: web.Request, handler):
    t0 = time.time()
    status = 500
    try:
        resp = await handler(request)
        status = resp.status
        return resp
    except web.HTTPException as exc:
        status = exc.status
        raise
    finally:
        # unmatched requests collapse to one label, so random paths cannot
        # grow the registry without bound
        route = (
            request.match_info.route.resource.canonical
            if request.match_info.route.resource is not None
            else "unmatched"
        )
        if route not in ("/metrics", "/healthz"):
            metrics.counter(
                "vst_http_requests_total",
                method=request.method,
                route=route,
                status=str(status),
            ).inc()
            metrics.histogram(
                "vst_http_request_seconds", method=request.method, route=route
            ).observe(time.time() - t0)


@web.middleware
async def _reject_malformed_middleware(request: web.Request, handler):
    """Parse and shape errors in a request body become 400 with the error
    text; anything else uncaught becomes a plain-text 500."""
    try:
        return await handler(request)
    except web.HTTPException:
        raise
    except (json.JSONDecodeError, UnicodeDecodeError, KeyError, TypeError, ValueError) as exc:
        return _json_error(400, f"malformed request: {exc!r}")
    except Exception as exc:  # noqa: BLE001
        log.exception("unhandled route error")
        return _json_error(500, f"internal error: {exc}")


def build_app(engine: EngineHandle) -> web.Application:
    app = web.Application(middlewares=[_metrics_middleware, _reject_malformed_middleware])
    app["engine"] = engine
    app["handle_cache"] = {}
    ix = "/api/v1/indexes/{keyspace}/{index}"
    app.add_routes(
        [
            web.get("/api/v1/text-search", get_text_indexes),
            web.put("/api/v1/text-search/{index}", put_text_index),
            web.post("/api/v1/text-search/{index}/add", post_text_add),
            web.post("/api/v1/text-search/{index}/search", post_text_search),
            web.get("/api/v1/indexes", get_ann_indexes),
            web.put(ix, put_ann_index),
            web.get(ix, get_ann_index_info),
            web.delete(ix, delete_ann_index),
            web.post(ix + "/ann", post_ann),
            web.get(ix + "/count", get_count),
            web.post(ix + "/add", post_ann_add),
            web.post(ix + "/remove", post_ann_remove),
            web.post(ix + "/compact", post_compact),
            web.get("/healthz", healthz),
            web.get("/metrics", get_metrics),
            web.get("/api-docs/openapi.json", get_openapi),
            web.get("/swagger-ui", get_swagger),
        ]
    )
    return app
