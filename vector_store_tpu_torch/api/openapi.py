"""OpenAPI 3.0 document of the port's two surfaces (text search and ANN),
and the Swagger UI page (counterpart of vector_store_tpu/api/openapi.py).

The UI page loads the swagger-ui assets from a CDN in the client's browser;
the server fetches nothing, and the JSON spec itself is always available."""

from __future__ import annotations


def _path_params(*named) -> list:
    return [
        {
            "name": name,
            "in": "path",
            "required": True,
            "schema": {"type": "string"},
            "description": desc,
        }
        for name, desc in named
    ]


def _index_params() -> list:
    return _path_params(("keyspace", "Keyspace"), ("index", "Index name"))


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
    tx = "/api/v1/text-search/{index}"
    return {
        "openapi": "3.0.3",
        "info": {
            "title": "vector-store-tpu (PyTorch/CUDA port)",
            "description": (
                "Vector search (graph, exact and IVF indexes) and BM25 text "
                "search service on a CUDA device"
            ),
            "version": "0.1.0",
        },
        "tags": [
            {"name": "text-search", "description": "Full-text index API"},
            {"name": "indexes", "description": "ANN (vector) index API"},
        ],
        "paths": {
            "/api/v1/text-search": {
                "get": {
                    "tags": ["text-search"],
                    "description": "Get list of current indexes",
                    "responses": {"200": {"description": "List of indexes"}},
                }
            },
            tx: {
                "put": {
                    "tags": ["text-search"],
                    "description": "Create an index",
                    "parameters": _path_params(("index", "Index to create")),
                    "responses": {"200": {"description": "An Index created"}},
                }
            },
            tx + "/add": {
                "post": {
                    "tags": ["text-search"],
                    "description": "Add an item to the index",
                    "parameters": _path_params(("index", "Index to add")),
                    "requestBody": _body(
                        ["id", "text"], {"id": {"type": "string"}, "text": {"type": "string"}}
                    ),
                    "responses": {
                        "200": {"description": "Add done"},
                        "404": {"description": "Index not found"},
                    },
                }
            },
            tx + "/search": {
                "post": {
                    "tags": ["text-search"],
                    "description": "Search in the index",
                    "parameters": _path_params(("index", "Index to search")),
                    "requestBody": _body(
                        ["text"],
                        {"text": {"type": "string"}, "limit": {"type": "integer", "default": 1}},
                    ),
                    "responses": {
                        "200": {"description": "Search result"},
                        "404": {"description": "Index not found"},
                    },
                }
            },
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
                                "enum": ["ann", "exact", "ivf", "auto", "text"],
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
                        "400": {"description": "Bad parameters or an unknown kind"},
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


def swagger_html() -> str:
    return """<!DOCTYPE html>
<html>
<head>
  <title>vector-store-tpu (PyTorch/CUDA port) — Swagger UI</title>
  <link rel="stylesheet"
        href="https://unpkg.com/swagger-ui-dist@5/swagger-ui.css">
</head>
<body>
<div id="swagger-ui"></div>
<script src="https://unpkg.com/swagger-ui-dist@5/swagger-ui-bundle.js"></script>
<script>
  window.onload = () => {
    SwaggerUIBundle({url: '/api-docs/openapi.json', dom_id: '#swagger-ui'});
  };
</script>
</body>
</html>
"""
