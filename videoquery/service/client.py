"""API client speaking the reference's coreapi action surface over HTTP
with the standard library alone (urllib).

The reference drives the Video Query REST API through the (abandoned)
coreapi dynamic-schema client: it fetches ``<url>/docs`` and addresses
endpoints as ``["resource", "verb"]`` action pairs (ticket.py:36-37,
api_repository.py:17-19). This client keeps the exact action-pair surface
(SURVEY.md Appendix A) so every call site reads like the reference, but
resolves actions through a static route table matching the API's DRF router
conventions — no coreapi dependency.

Error handling parity: every request retries forever on connection errors
with a 50 ms backoff (reference ticket.py:384-400, target_clip.py:288-295,
api_load_records.py:115-121).
"""

from __future__ import annotations

import functools
import json
import logging
import os
import time
import urllib.error
import urllib.parse
import urllib.request
import uuid
from typing import Any, Mapping, Protocol, Sequence

log = logging.getLogger(__name__)

RETRY_SLEEP_SECONDS = 0.05  # reference ticket.py:388


class Transport(Protocol):
    def request(
        self,
        method: str,
        path: str,
        *,
        params: Mapping[str, Any] | None = None,
        data: Mapping[str, Any] | None = None,
        files: Mapping[str, Any] | None = None,
    ) -> Any: ...


class Response:
    """Status and body of one HTTP exchange (4xx/5xx included: the API's
    error bodies are JSON the caller may read, as with any other status)."""

    def __init__(self, status_code: int, content: bytes):
        self.status_code = status_code
        self.content = content

    def json(self) -> Any:
        return json.loads(self.content)


def _multipart(data: Mapping[str, Any], files: Mapping[str, Any]
               ) -> tuple[bytes, str]:
    """multipart/form-data body: one part per field, file objects (anything
    with .read()) as file parts named after the object's basename."""
    boundary = uuid.uuid4().hex
    out = []
    for key, val in data.items():
        out.append(f'--{boundary}\r\nContent-Disposition: form-data; '
                   f'name="{key}"\r\n\r\n{val}\r\n'.encode())
    for key, f in files.items():
        name = os.path.basename(str(getattr(f, "name", key)))
        payload = f.read()
        if isinstance(payload, str):
            payload = payload.encode()
        out.append(f'--{boundary}\r\nContent-Disposition: form-data; '
                   f'name="{key}"; filename="{name}"\r\nContent-Type: '
                   f'application/octet-stream\r\n\r\n'.encode())
        out.append(payload + b"\r\n")
    out.append(f"--{boundary}--\r\n".encode())
    return b"".join(out), f"multipart/form-data; boundary={boundary}"


class Session:
    """The few HTTP calls the client needs, on urllib: persistent headers,
    query strings, form / JSON / multipart bodies."""

    def __init__(self):
        self.headers: dict[str, str] = {}

    def request(self, method: str, url: str, *, params=None, data=None,
                json_body=None, files=None) -> Response:
        if params:
            query = urllib.parse.urlencode(
                {k: v for k, v in params.items() if v is not None},
                doseq=True)
            url += ("&" if "?" in url else "?") + query
        headers = dict(self.headers)
        body = None
        if files:
            body, headers["Content-Type"] = _multipart(data or {}, files)
        elif json_body is not None:
            body = json.dumps(json_body).encode()
            headers["Content-Type"] = "application/json"
        elif data is not None:
            body = urllib.parse.urlencode(data, doseq=True).encode()
            headers["Content-Type"] = "application/x-www-form-urlencoded"
        req = urllib.request.Request(url, data=body, headers=headers,
                                     method=method)
        try:
            with urllib.request.urlopen(req) as resp:
                return Response(resp.status, resp.read())
        except urllib.error.HTTPError as err:
            return Response(err.code, err.read())

    def get(self, url: str) -> Response:
        return self.request("GET", url)

    def post(self, url: str, data=None) -> Response:
        return self.request("POST", url, data=data)


def _is_connection_error(exc: Exception) -> bool:
    return isinstance(exc, (ConnectionError, urllib.error.URLError)) \
        and not isinstance(exc, urllib.error.HTTPError)


def authenticate(api_url: str, session=None):
    """POST api-token-auth/ with API_CLIENT_USERNAME/API_CLIENT_PASSWORD env
    credentials; returns the token or None on failure (reference
    authenticate.py:6-24)."""
    session = session or Session()
    try:
        resp = session.post(
            api_url.rstrip("/") + "/api-token-auth/",
            data={
                "username": os.environ["API_CLIENT_USERNAME"],
                "password": os.environ["API_CLIENT_PASSWORD"],
            },
        )
        return resp.json()["token"]
    except Exception as exc:  # parity: reference prints and returns None
        log.error("Client Authentication Failed: %s", exc)
        return None


class HTTPTransport:
    """urllib-backed transport with token auth and infinite connection
    retry."""

    def __init__(self, base_url: str, token: str | None = None,
                 fetch_schema: bool = True):
        self.base_url = base_url.rstrip("/") + "/"
        self.session = Session()
        if token is None:
            token = authenticate(self.base_url, self.session)
        if token:
            self.session.headers["Authorization"] = f"Token {token}"
        if fetch_schema:
            # Contract parity: the reference fetches the schema document at
            # startup (api_repository.py:19); we hit it once as a liveness /
            # auth check but resolve routes statically.
            try:
                self.session.get(self.base_url + "docs")
            except Exception:
                log.warning("could not fetch %sdocs; continuing", self.base_url)

    def request(self, method, path, *, params=None, data=None, files=None):
        while True:
            try:
                resp = self.session.request(
                    method,
                    self.base_url + path,
                    params=params if method == "GET" else None,
                    data=data if files else None,
                    json_body=data if (data is not None and not files) else None,
                    files=files,
                )
                if resp.status_code == 204 or not resp.content:
                    return None
                return resp.json()
            except Exception as exc:
                if not _is_connection_error(exc):
                    raise
                time.sleep(RETRY_SLEEP_SECONDS)
                log.warning("Try API request again: %s %s params=%s",
                            method, path, params)


# Action resolution: ["resource", ..., verb] -> (method, path template).
# Collection verbs take filter params in the query string; detail verbs
# consume the "id" param into the path (DRF router conventions used by the
# Video Query API; surface inventoried in SURVEY.md Appendix A).
_DETAIL_VERBS = {"read": "GET", "partial_update": "PATCH", "update": "PUT",
                 "delete": "DELETE", "features": "GET"}
_COLLECTION_VERBS = {"list": "GET", "create": "POST"}


def _route_overrides() -> dict[tuple[str, ...], tuple[str, str, bool]]:
    """Escape hatch if the live Django API's router differs from the static
    table: VIDEOQUERY_ROUTE_OVERRIDES='{"videos.list": ["GET", "video/", false]}'
    (keys are dot-joined action pairs; values [method, path-template,
    is_detail] — detail templates contain '{id}'). Parsed once per env
    value — not per request."""
    return _parse_route_overrides(
        os.environ.get("VIDEOQUERY_ROUTE_OVERRIDES") or "")


@functools.lru_cache(maxsize=4)
def _parse_route_overrides(raw: str) -> dict:
    if not raw:
        return {}
    import json

    try:
        table = json.loads(raw)
        return {tuple(k.split(".")): (v[0], v[1], bool(v[2]))
                for k, v in table.items()}
    except Exception as exc:  # noqa: BLE001
        log.error("bad VIDEOQUERY_ROUTE_OVERRIDES (%s); ignoring", exc)
        return {}


def resolve_action(action: Sequence[str]) -> tuple[str, str, bool]:
    """Returns (method, path-template, is_detail). Detail paths contain
    '{id}'."""
    override = _route_overrides().get(tuple(action))
    if override is not None:
        return override
    action = list(action)
    verb = action[-1]
    resource = "/".join(action[:-1])
    if len(action) >= 3 and verb == "list":
        # nested list routes, e.g. ["query-state", "compute-new", "list"]
        return "GET", f"{resource}/", False
    if verb in _COLLECTION_VERBS:
        return _COLLECTION_VERBS[verb], f"{resource}/", False
    if verb in _DETAIL_VERBS:
        suffix = "" if verb in ("read", "partial_update", "update", "delete") else f"{verb}/"
        return _DETAIL_VERBS[verb], f"{resource}/{{id}}/{suffix}", True
    raise ValueError(f"unknown action verb {verb!r} in {action}")


class ActionClient:
    """coreapi-compatible facade: client.action(schema-less action pair)."""

    def __init__(self, transport: Transport):
        self.transport = transport

    def action(
        self,
        action: Sequence[str],
        params: Mapping[str, Any] | None = None,
        encoding: str | None = None,
    ) -> Any:
        method, template, is_detail = resolve_action(action)
        params = dict(params or {})
        files = None
        if encoding == "multipart/form-data":
            files = {
                k: v for k, v in params.items() if hasattr(v, "read")
            }
            params = {k: v for k, v in params.items() if not hasattr(v, "read")}
        path = template
        if is_detail:
            path = template.format(id=params.pop("id"))
        if method == "GET":
            return self.transport.request(method, path, params=params)
        return self.transport.request(method, path, data=params, files=files)


def make_client(base_url: str, transport: Transport | None = None) -> ActionClient:
    return ActionClient(transport or HTTPTransport(base_url))
