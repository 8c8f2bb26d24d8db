"""OpenAPI 3.0 document of the port's ANN surface (the text-search routes
answer 400 until the text backend is ported)."""

from __future__ import annotations


def _index_params() -> list:
    return [
        {
            "name": name,
            "in": "path",
            "required": True,
            "schema": {"type": "string"},
            "description": desc,
        }
        for name, desc in (("keyspace", "Keyspace"), ("index", "Index name"))
    ]


def _body(required: list, properties: dict) -> dict:
    return {
        "content": {
            "application/json": {
                "schema": {"type": "object", "required": required, "properties": properties}
            }
        }
    }


_EMBEDDING = {"type": "array", "items": {"type": "number"}}
_FOUND = {"200": {"description": "ok"}, "404": {"description": "Index not found"}}


def openapi_spec() -> dict:
    ix = "/api/v1/indexes/{keyspace}/{index}"
    return {
        "openapi": "3.0.3",
        "info": {
            "title": "vector-store-tpu (PyTorch/CUDA port)",
            "description": "Vector search service (graph, exact and IVF indexes) on a CUDA device",
            "version": "0.1.0",
        },
        "tags": [{"name": "indexes", "description": "ANN (vector) index API"}],
        "paths": {
            "/api/v1/indexes": {
                "get": {
                    "tags": ["indexes"],
                    "description": "List ANN indexes",
                    "responses": {"200": {"description": "List of index ids"}},
                }
            },
            ix: {
                "put": {
                    "tags": ["indexes"],
                    "description": "Create an ANN index (kind ann, the graph, by default)",
                    "parameters": _index_params(),
                    "requestBody": _body(
                        ["dimensions"],
                        {
                            "dimensions": {"type": "integer"},
                            "space": {"type": "string", "enum": ["cosine", "l2", "dot"]},
                            "dtype": {
                                "type": "string",
                                "enum": ["float32", "bfloat16", "int8"],
                            },
                            "kind": {
                                "type": "string",
                                "enum": ["ann", "exact", "ivf", "auto"],
                                "default": "ann",
                            },
                            "capacity": {
                                "type": "integer",
                                "description": "declared rows; kind auto picks ivf at >= 200000",
                            },
                            "key_columns": {"type": "array", "items": {"type": "string"}},
                        },
                    ),
                    "responses": {
                        "200": {"description": "Created"},
                        "400": {"description": "Bad parameters or a kind not yet ported (text)"},
                    },
                },
                "get": {
                    "tags": ["indexes"],
                    "description": "Kind, parameters and live count",
                    "parameters": _index_params(),
                    "responses": _FOUND,
                },
                "delete": {
                    "tags": ["indexes"],
                    "description": "Drop an ANN index",
                    "parameters": _index_params(),
                    "responses": {"200": {"description": "Dropped"}},
                },
            },
            ix + "/ann": {
                "post": {
                    "tags": ["indexes"],
                    "description": "Nearest-neighbour search",
                    "parameters": _index_params(),
                    "requestBody": _body(
                        ["embedding"],
                        {"embedding": _EMBEDDING, "limit": {"type": "integer", "default": 1}},
                    ),
                    "responses": _FOUND,
                }
            },
            ix + "/count": {
                "get": {
                    "tags": ["indexes"],
                    "description": "Number of live items",
                    "parameters": _index_params(),
                    "responses": _FOUND,
                }
            },
            ix + "/add": {
                "post": {
                    "tags": ["indexes"],
                    "description": "Upsert an embedding",
                    "parameters": _index_params(),
                    "requestBody": _body(
                        ["primary_key", "embedding"],
                        {"primary_key": {"type": "array"}, "embedding": _EMBEDDING},
                    ),
                    "responses": _FOUND,
                }
            },
            ix + "/remove": {
                "post": {
                    "tags": ["indexes"],
                    "description": "Remove a primary key",
                    "parameters": _index_params(),
                    "requestBody": _body(["primary_key"], {"primary_key": {"type": "array"}}),
                    "responses": _FOUND,
                }
            },
            ix + "/compact": {
                "post": {
                    "tags": ["indexes"],
                    "description": "Reclaim tombstoned rows; returns the live count",
                    "parameters": _index_params(),
                    "responses": _FOUND,
                }
            },
            "/healthz": {
                "get": {
                    "description": "Liveness probe",
                    "responses": {"200": {"description": "ok"}},
                }
            },
            "/metrics": {
                "get": {
                    "description": "Prometheus text exposition",
                    "responses": {"200": {"description": "metrics text"}},
                }
            },
        },
    }
