"""OpenAI-compatible HTTP serving front-end (port of ome_tpu/engine/server.py).

The same surface as the reference (/v1/completions,
/v1/chat/completions, /health, /ready, /metrics, /v1/models and the
opt-in /debug endpoints), fronting the PyTorch engine. stdlib
http.server keeps the dependency footprint zero; a threading server is
plenty because request handlers only enqueue work and read token
queues — the device is driven by the single scheduler thread.

Structured outputs: `response_format` `json_object` and `json_schema`
(whose `pattern` keywords take regular expressions) attach a grammar
masker to the request, as in the reference; `text` is unconstrained.

PD and prefix reuse: `POST /pd/prefill` runs the `pd_prefill` handler
(engine/pd.py) of a PD prefill node or of a replica that donates its
prefix cache, and answers the KV wire blob; a completion's
`X-OME-Prefix-Peer` header names the replica to fetch its prefix from.

Multi-LoRA: a completion whose `model` names a registered adapter
decodes with it (an unknown id is a 404 once adapters are loaded);
`/v1/models` and `/ready` list the adapters; `POST /v1/adapters
{name, path}` hot-loads a PEFT directory into a free slot and `DELETE
/v1/adapters/<name>` removes one (409, retryable, while it decodes).
Embeddings: a `--task embed` deployment answers `POST /v1/embeddings`
(`engine/embed.py`) and refuses generation.

Performance attribution: `GET /debug/programs` (with
`--debug-endpoints`) serves the engine's program cost ledger
(perf/ledger.py), and `POST /debug/profile?seconds=N` (with
`--profile-dir`) takes an on-demand torch.profiler trace of the card
(telemetry/profiler.py).
"""

from __future__ import annotations

import codecs
import json
import math
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .. import faults
from ..priority import coerce_priority
from ..telemetry import Registry, tracing
from ..telemetry import profiler as _profiler
from ..models.checkpoint import SafetensorsError
from ..telemetry.reqlog import coerce as _coerce_reqlog
# the router's prefix-affinity key and digest: the digests this replica
# advertises on /ready meet the router's fleet prefix directory
from ..router.server import affinity_from_payload, prefix_digest
from .scheduler import (Request, Scheduler, SchedulerDraining,
                        SchedulerOverloaded)
from .tokenizer import load_tokenizer

# bounded path label for the HTTP counter: anything off this list
# (adapter DELETEs carry a name, typos, scans) collapses to "other"
# so request paths can never explode label cardinality
_KNOWN_PATHS = frozenset((
    "/health", "/healthz", "/ready", "/metrics", "/v1/models",
    "/v1/completions", "/v1/chat/completions", "/v1/embeddings",
    "/v1/adapters", "/pd/prefill", "/debug/profile",
    "/debug/events", "/debug/state", "/debug/programs"))


def _path_label(path: str) -> str:
    base = path.split("?", 1)[0]
    if base.startswith("/v1/adapters/"):
        return "/v1/adapters"
    return base if base in _KNOWN_PATHS else "other"


def _retry_after_str(seconds) -> str:
    """Clamp a retry hint onto the [1, 30]s Retry-After contract:
    long enough that a retry can succeed, short enough that clients
    do not park for minutes on a transient spike."""
    try:
        val = math.ceil(float(seconds))
    except (TypeError, ValueError):
        val = 1
    return str(int(min(max(val, 1), 30)))


class EngineServer:
    def __init__(self, scheduler: Scheduler, tokenizer=None,
                 model_name: str = "ome-model", host: str = "127.0.0.1",
                 port: int = 0,
                 ready_queue_limit: Optional[int] = None,
                 registry: Optional[Registry] = None,
                 request_log=None, profile_dir: Optional[str] = None,
                 debug_endpoints: bool = False,
                 fetch_bps: Optional[float] = None,
                 pd_prefill=None, embedder=None, structured: bool = True):
        self.scheduler = scheduler
        self.embedder = embedder  # engine/embed.py EmbeddingEngine
        # structured outputs need the decode loop's grammar masks; an
        # embeddings deployment has none
        self.structured = structured
        # engine/pd.py make_pd_prefill_handler: a PD prefill node's, or
        # a prefix donor's, POST /pd/prefill (None: 404)
        self.pd_prefill = pd_prefill
        self.tokenizer = tokenizer or load_tokenizer()
        self.model_name = model_name
        # measured weight-fetch throughput from the published fetch
        # manifest (weightplane.published_fetch_bps): advertised on
        # /ready so the router's cold-start Retry-After math uses the
        # fleet's REAL bandwidth, not a default guess
        self.fetch_bps = fetch_bps
        # one registry per serving process: the scheduler already owns
        # one (its counters/histograms live there); share it so one
        # /metrics scrape exposes the whole process
        self.registry = (registry
                         or getattr(scheduler, "registry", None)
                         or Registry())
        # JSONL request log: RequestLog instance, path, or None (off)
        self.request_log = _coerce_reqlog(request_log)
        # POST /debug/profile exists only when the operator named a
        # directory for its traces (--profile-dir); 403 otherwise
        self.profile_dir = profile_dir
        # GET /debug/events + /debug/state are the same kind of
        # operator opt-in (--debug-endpoints): they expose request ids
        # and scheduler internals, so they answer 403 by default
        self.debug_endpoints = debug_endpoints
        self._http_requests = self.registry.counter(
            "ome_engine_http_requests_total",
            "HTTP requests served, by (bounded) path",
            labelnames=("path",))
        self._g_uptime = self.registry.gauge(
            "ome_engine_uptime_seconds",
            "Seconds since this server started")
        # /ready flips not-ready above this pending depth (readiness
        # steers the router/k8s away BEFORE the queue saturates into
        # 429s); default: half the scheduler's pending capacity
        if ready_queue_limit is None:
            maxp = getattr(getattr(scheduler, "pending", None),
                           "maxsize", 0) or 512
            ready_queue_limit = max(maxp // 2, 1)
        self.ready_queue_limit = ready_queue_limit
        # graceful drain (SIGTERM, docs/durability.md): /ready flips
        # to 503 so the router health loop stops selecting this
        # replica, and new work answers 503 + Retry-After with the
        # X-OME-Draining marker the router treats as "skip, don't
        # count a failure"; in-flight requests keep streaming
        self.draining = False
        # callables run by stop() once the scheduler has stopped
        self.on_stop: list = []
        self.started_at = time.time()
        # cross-replica prefix reuse (docs/kv-hierarchy.md): digests
        # of recently served prefixes, reported in the /ready body so
        # the router's fleet prefix directory learns ownership from
        # the health probes it already makes. Only replicas with a
        # live prefix cache advertise (a digest from a cacheless
        # replica would invite pointless peer fetches).
        import collections
        self._prefix_digests: "collections.OrderedDict[str, bool]" = \
            collections.OrderedDict()
        self._prefix_digest_cap = 32
        self._prefix_digest_lock = threading.Lock()
        _eng = getattr(scheduler, "engine", None)
        self._report_prefixes = bool(getattr(
            getattr(_eng, "prefix_cache", None), "capacity_bytes", 0))
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # quiet
                pass

            # -- helpers ----------------------------------------------
            def _json(self, code: int, obj, headers=None):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _body(self):
                n = int(self.headers.get("Content-Length") or 0)
                return json.loads(self.rfile.read(n) or b"{}")

            # -- GET --------------------------------------------------
            def do_GET(self):
                outer._http_requests.labels(
                    path=_path_label(self.path)).inc()
                if self.path in ("/health", "/healthz"):
                    # LIVENESS: only `dead` (restart budget exhausted)
                    # should make k8s restart the pod — `degraded`
                    # (mid-recovery) is a normal operating condition
                    status = getattr(outer.scheduler, "status",
                                     "ok" if outer.scheduler.healthy
                                     else "dead")
                    sched = outer.scheduler
                    self._json(200 if status != "dead" else 503, {
                        "status": status,
                        "draining": outer.draining,
                        "restarts": sched.stats.get(
                            "restarts_total", 0)
                        if getattr(sched, "stats", None) else 0,
                        "pipeline_depth": getattr(
                            sched, "pipeline_depth", 0),
                        "spec_tokens": getattr(
                            sched, "spec_tokens", 0),
                        "steps_per_dispatch": getattr(
                            sched, "steps_per_dispatch", 1),
                        # per-cause planner degradation counts: a
                        # nonzero `masked` here means a composition
                        # regression, visible without a metrics scrape
                        "degradations": getattr(
                            sched, "degradations", {}),
                        "uptime_s": round(
                            time.time() - outer.started_at, 1)})
                elif self.path == "/ready":
                    # READINESS: take this replica out of rotation
                    # while it is recovering OR its queue is deep —
                    # without restarting it
                    status = getattr(outer.scheduler, "status",
                                     "ok" if outer.scheduler.healthy
                                     else "dead")
                    pend = getattr(outer.scheduler, "pending", None)
                    depth = pend.qsize() if pend is not None else 0
                    ready = (status == "ok"
                             and not outer.draining
                             and depth <= outer.ready_queue_limit)
                    self._json(200 if ready else 503, {
                        "ready": ready, "status": status,
                        "draining": outer.draining,
                        "queue_depth": depth,
                        "queue_limit": outer.ready_queue_limit,
                        # prefix-directory piggyback: the router's
                        # health probe carries these into the fleet
                        # prefix directory (router/server.py)
                        "prefix_digests": outer.prefix_digests(),
                        # model advertisement (docs/model-fleet.md):
                        # the router's model map learns which model
                        # ids this replica serves — base + adapters —
                        # and the measured fetch throughput feeding
                        # its cold-start Retry-After
                        "model": outer.model_name,
                        "models": [outer.model_name]
                        + outer._adapter_names(),
                        "fetch_bps": outer.fetch_bps})
                elif self.path == "/v1/models":
                    data = [{"id": outer.model_name, "object": "model",
                             "owned_by": "ome-tpu"}]
                    # multi-LoRA: each adapter serves as its own model
                    # id (the vLLM/SGLang convention the reference's
                    # FineTunedWeight serving relies on)
                    for name in outer._adapter_names():
                        data.append({"id": name, "object": "model",
                                     "owned_by": "ome-tpu",
                                     "parent": outer.model_name})
                    self._json(200, {"object": "list", "data": data})
                elif self.path == "/metrics":
                    # point-in-time gauges refresh at scrape; counter/
                    # histogram series stream in as requests run
                    upd = getattr(outer.scheduler, "update_gauges",
                                  None)
                    if upd is not None:
                        upd()
                    outer._g_uptime.set(time.time() - outer.started_at)
                    body = outer.registry.render().encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/plain; version=0.0.4")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path.split("?", 1)[0] == "/debug/events":
                    self._debug_events()
                elif self.path.split("?", 1)[0] == "/debug/state":
                    self._debug_state()
                elif self.path.split("?", 1)[0] == "/debug/programs":
                    self._debug_programs()
                else:
                    self._json(404, {"error": "not found"})

            def _debug_guard(self) -> bool:
                """Shared 403 gate for the debug introspection
                surfaces — same opt-in discipline as /debug/profile."""
                if outer.debug_endpoints:
                    return True
                self._json(403, {
                    "error": "debug endpoints disabled (launch with "
                             "--debug-endpoints to enable)"})
                return False

            def _debug_events(self):
                """GET /debug/events?n=K — the tail of the scheduler's
                flight-recorder ring (telemetry/flight.py), newest
                last."""
                if not self._debug_guard():
                    return
                fl = getattr(outer.scheduler, "flight", None)
                if fl is None:
                    return self._json(404, {
                        "error": "scheduler has no flight recorder"})
                qs = urllib.parse.urlparse(self.path).query
                params = urllib.parse.parse_qs(qs)
                try:
                    n = int(params.get("n", ["256"])[0])
                except ValueError:
                    return self._json(400, {
                        "error": "n must be an integer"})
                doc = fl.state()
                doc["events"] = fl.snapshot(n)
                return self._json(200, doc)

            def _debug_programs(self):
                """GET /debug/programs — the engine's program cost
                ledger (perf/ledger.py): one entry per program key with
                FLOPs, bytes moved, argument/output bytes and expected
                roofline ms."""
                if not self._debug_guard():
                    return
                led = getattr(getattr(outer.scheduler, "engine", None),
                              "ledger", None)
                if led is None:
                    return self._json(404, {
                        "error": "engine has no program ledger"})
                return self._json(200, {
                    "device": led.device_spec(),
                    "mode": led.mode,
                    "count": len(led),
                    "programs": led.snapshot()})

            def _debug_state(self):
                """GET /debug/state — live scheduler snapshot (slots,
                queue, KV pool, journal, drain), the point-in-time
                complement to the flight recorder's history."""
                if not self._debug_guard():
                    return
                state_fn = getattr(outer.scheduler, "debug_state",
                                   None)
                if state_fn is None:
                    return self._json(404, {
                        "error": "scheduler has no debug_state"})
                return self._json(200, state_fn())

            # -- POST -------------------------------------------------
            def do_POST(self):
                outer._http_requests.labels(
                    path=_path_label(self.path)).inc()
                code = faults.http("server_http", key=outer.model_name)
                if code is not None:  # injected backend fault (tests)
                    return self._json(code, {
                        "error": f"injected fault (HTTP {code})"},
                        headers={"Retry-After": "1"})
                if outer.draining and self.path.split("?", 1)[0] in (
                        "/v1/completions", "/v1/chat/completions",
                        "/v1/embeddings", "/pd/prefill"):
                    # drain rejection: X-OME-Draining tells the router
                    # to fail over WITHOUT charging this replica a
                    # circuit-breaker failure or a retry token
                    return self._json(503, {
                        "error": "replica draining (shutting down); "
                                 "retry another backend",
                        "draining": True},
                        headers={"Retry-After": outer._retry_after(2.0),
                                 "X-OME-Draining": "1"})
                if self.path.split("?", 1)[0] == "/debug/profile":
                    return self._profile()
                try:
                    payload = self._body()
                except Exception as e:
                    return self._json(400, {"error": str(e)})
                if self.path == "/v1/completions":
                    return self._complete(payload, chat=False)
                if self.path == "/v1/chat/completions":
                    return self._complete(payload, chat=True)
                if self.path == "/v1/embeddings":
                    return self._embeddings(payload)
                if self.path == "/pd/prefill":
                    return self._pd_prefill(payload)
                if self.path == "/v1/adapters":
                    return self._register_adapter(payload)
                self._json(404, {"error": "not found"})

            def _register_adapter(self, payload):
                """Hot-load a staged PEFT adapter dir into a LoRA slot
                (the serving-agent sidecar calls this after staging)."""
                eng = getattr(outer.scheduler, "engine", None)
                if eng is None or not hasattr(eng, "register_adapter"):
                    return self._json(400, {
                        "error": "engine has no adapter support"})
                name = payload.get("name")
                path = payload.get("path")
                if not name or not path:
                    return self._json(400, {
                        "error": "need {name, path}"})
                try:
                    idx = eng.register_adapter(name, path)
                except (ValueError, OSError, SafetensorsError) as e:
                    return self._json(400, {"error": str(e)})
                return self._json(200, {"name": name, "slot": idx})

            def _embeddings(self, payload):
                if outer.embedder is None:
                    return self._json(400, {
                        "error": "this deployment does not serve "
                                 "embeddings (--task embed)"})
                texts = payload.get("input", [])
                if isinstance(texts, str):
                    texts = [texts]
                tok = outer.tokenizer
                try:
                    # OpenAI-compat: elements may be strings or
                    # pre-tokenized id arrays
                    ids = [list(t) if isinstance(t, (list, tuple))
                           else tok.encode(t) for t in texts]
                    embs = outer.embedder.embed(ids)
                except (TypeError, ValueError) as e:
                    return self._json(400, {"error": str(e)})
                self._json(200, {
                    "object": "list", "model": outer.model_name,
                    "data": [{"object": "embedding", "index": i,
                              "embedding": emb.tolist()}
                             for i, emb in enumerate(embs)],
                    "usage": {"prompt_tokens": sum(map(len, ids)),
                              "total_tokens": sum(map(len, ids))}})

            def _pd_prefill(self, payload):
                if outer.pd_prefill is None:
                    return self._json(404, {
                        "error": "this node does not serve PD prefill "
                                 "(--disaggregation-mode prefill, or a "
                                 "prefix cache)"})
                try:
                    blob = outer.pd_prefill(payload)
                except Exception as e:  # noqa: BLE001 — surface to the
                    # decode node, which fails the one request
                    return self._json(500, {"error": str(e)})
                self.send_response(200)
                self.send_header("Content-Type",
                                 "application/octet-stream")
                self.send_header("Content-Length", str(len(blob)))
                self.end_headers()
                self.wfile.write(blob)

            def _profile(self):
                """POST /debug/profile?seconds=N — guarded on-demand
                torch.profiler capture (telemetry/profiler.py)."""
                if outer.profile_dir is None:
                    return self._json(403, {
                        "error": "profiling disabled (launch with "
                                 "--profile-dir to enable)"})
                qs = urllib.parse.urlparse(self.path).query
                params = urllib.parse.parse_qs(qs)
                led = getattr(getattr(outer.scheduler, "engine", None),
                              "ledger", None)
                try:
                    seconds = float(params.get("seconds", ["1"])[0])
                    result = _profiler.capture(outer.profile_dir,
                                               seconds, ledger=led)
                except ValueError as e:
                    return self._json(400, {"error": str(e)})
                except _profiler.ProfileInProgress as e:
                    return self._json(409, {"error": str(e)},
                                      headers={"Retry-After": "1"})
                return self._json(200, result)

            def do_DELETE(self):
                outer._http_requests.labels(
                    path=_path_label(self.path)).inc()
                if self.path.startswith("/v1/adapters/"):
                    name = self.path.rsplit("/", 1)[-1]
                    eng = getattr(outer.scheduler, "engine", None)
                    if eng is None or not hasattr(eng,
                                                  "unregister_adapter"):
                        return self._json(400, {
                            "error": "engine has no adapter support"})
                    try:
                        eng.unregister_adapter(name)
                    except ValueError as e:
                        # busy adapter (in-flight sequences): a
                        # structured retryable conflict, not a dropped
                        # connection
                        return self._json(409, {"error": str(e),
                                                "retryable": True})
                    return self._json(200, {"removed": name})
                self._json(404, {"error": "not found"})

            def _complete(self, payload, chat: bool):
                tok = outer.tokenizer
                if chat:
                    prompt = tok.apply_chat_template(
                        payload.get("messages", []))
                else:
                    prompt = payload.get("prompt", "")
                    if isinstance(prompt, list):
                        if prompt and isinstance(prompt[0], int):
                            # OpenAI allows pre-tokenized prompts
                            prompt = list(map(int, prompt))
                        else:
                            prompt = "".join(prompt)
                masker = None
                rf = payload.get("response_format") or {}
                if rf:
                    kind = rf.get("type")
                    if kind not in ("json_object", "json_schema",
                                    "text", None):
                        return self._json(400, {
                            "error": f"response_format type {kind!r} "
                                     "is not supported (json_object, "
                                     "json_schema and text are)"})
                    if kind in ("json_object", "json_schema"):
                        if not outer.structured:
                            return self._json(400, {
                                "error": "structured outputs are not "
                                         "available on this node "
                                         "(embeddings deployment)"})
                        from .structured import TokenMasker
                        if kind == "json_schema":
                            from .schema import (SchemaAutomaton,
                                                 SchemaError)
                            spec = rf.get("json_schema") or {}
                            if "schema" not in spec:
                                # a missing schema must not silently
                                # degrade to unconstrained output
                                return self._json(400, {
                                    "error": "response_format "
                                             "json_schema requires "
                                             "json_schema.schema"})
                            try:
                                auto = SchemaAutomaton(spec["schema"])
                            except SchemaError as e:
                                return self._json(400, {
                                    "error": f"json_schema: {e}"})
                            masker = TokenMasker(tok, automaton=auto)
                        else:
                            # OpenAI json_object means a JSON OBJECT,
                            # not any value — root must open with '{'
                            masker = TokenMasker(tok, object_root=True)
                # multi-LoRA routing: a request whose model id names a
                # registered adapter decodes with that adapter's
                # deltas; an id matching NEITHER the base nor an
                # adapter is an error, not a silent base fallback
                adapter = None
                mdl = payload.get("model")
                if mdl and mdl != outer.model_name:
                    names = outer._adapter_names()
                    if mdl in names:
                        adapter = mdl
                    elif names:
                        # with adapters loaded the model id ROUTES, so
                        # an unknown id must 404 rather than silently
                        # serving the base model; without adapters,
                        # keep the permissive single-model behavior
                        return self._json(404, {
                            "error": f"model {mdl!r} not found "
                                     f"(serving {outer.model_name}, "
                                     "adapters: " + ", ".join(names)
                                     + ")"})
                # per-request deadline: payload `timeout` is RELATIVE
                # seconds; the X-Request-Deadline header (router-
                # propagated) is ABSOLUTE epoch seconds. Both convert
                # to the scheduler's monotonic clock; tightest wins.
                deadline = None
                try:
                    rel = payload.get("timeout")
                    if rel is not None:
                        deadline = time.monotonic() + float(rel)
                    hdr = self.headers.get("X-Request-Deadline")
                    if hdr:
                        mono = time.monotonic() + (float(hdr)
                                                   - time.time())
                        deadline = mono if deadline is None \
                            else min(deadline, mono)
                except (TypeError, ValueError):
                    return self._json(400, {
                        "error": "timeout / X-Request-Deadline must "
                                 "be numeric seconds"})
                # priority class (docs/multi-tenancy.md): the
                # X-OME-Priority header (router-propagated) wins over
                # the payload field; an unknown value is a 400, never
                # a silent reclassification into another tenant class
                try:
                    pri = coerce_priority(
                        self.headers.get("X-OME-Priority")
                        or payload.get("priority"))
                except ValueError as e:
                    return self._json(400, {"error": str(e)})
                req = Request(
                    priority=pri,
                    prompt_ids=prompt if isinstance(prompt, list)
                    else tok.encode(prompt),
                    max_new_tokens=int(payload.get("max_tokens", 64)),
                    temperature=float(payload.get("temperature", 0.0)),
                    top_k=int(payload.get("top_k", 0)),
                    top_p=float(payload.get("top_p", 1.0)),
                    masker=masker, adapter=adapter, deadline=deadline,
                    # router-injected donor peer for cross-replica
                    # prefix reuse; admission fetches the prefix KV
                    # from it (engine/peering.py) or recomputes
                    prefix_peer=self.headers.get("X-OME-Prefix-Peer")
                    or None,
                    # adopt the router's trace (traceparent header) or
                    # mint one, so standalone engines still correlate
                    trace=tracing.from_headers(self.headers),
                    stop_ids=[tok.eos_id] if tok.eos_id is not None else [])
                try:
                    outer.scheduler.submit(req)
                except SchedulerOverloaded as e:
                    # bounded-wait admission control: the hint is the
                    # scheduler's estimated queue wait for this class,
                    # so the client (or the router's retry budget)
                    # comes back when there is actually room
                    outer._log_request(req, outcome="rejected")
                    return self._json(429, {"error": str(e)},
                                      headers={"Retry-After":
                                          _retry_after_str(
                                              e.retry_after)})
                except SchedulerDraining as e:
                    # drain began between the do_POST gate and this
                    # submit: same 503 + draining marker
                    outer._log_request(req, outcome="rejected")
                    return self._json(503, {"error": str(e),
                                            "draining": True},
                                      headers={"Retry-After":
                                          _retry_after_str(
                                              e.retry_after),
                                          "X-OME-Draining": "1"})
                except Exception as e:
                    outer._log_request(req, outcome="rejected")
                    return self._json(503, {"error": str(e)},
                                      headers={"Retry-After":
                                          outer._retry_after()})
                # admitted: this replica is about to hold the prompt's
                # prefix KV — advertise its digest to the fleet
                outer._note_prefix(payload)
                if payload.get("stream"):
                    try:
                        return self._stream(req, chat)
                    finally:
                        outer._log_request(req)
                if req.deadline is not None:
                    # bounded wait: if the scheduler has not finished
                    # the request shortly after its deadline (it may
                    # still sit queued), time it out from here —
                    # finish() is first-wins, so this races safely
                    remaining = req.deadline - time.monotonic()
                    if not req.done.wait(max(remaining, 0) + 0.25):
                        req.finish("timeout")
                        req.done.wait()
                else:
                    req.done.wait()
                outer._log_request(req)
                text = tok.decode(req.output_ids)
                usage = {"prompt_tokens": len(req.prompt_ids),
                         "completion_tokens": len(req.output_ids),
                         "total_tokens": len(req.prompt_ids)
                         + len(req.output_ids)}
                if chat:
                    choice = {"index": 0, "message": {
                        "role": "assistant", "content": text},
                        "finish_reason": req.finish_reason}
                    obj = "chat.completion"
                else:
                    choice = {"index": 0, "text": text,
                              "finish_reason": req.finish_reason}
                    obj = "text_completion"
                self._json(200, {
                    "id": f"cmpl-{req.id}", "object": obj,
                    "created": int(time.time()),
                    "model": outer.model_name,
                    "choices": [choice], "usage": usage})

            def _stream(self, req: Request, chat: bool):
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()

                def chunk(data: bytes):
                    self.wfile.write(f"{len(data):x}\r\n".encode()
                                     + data + b"\r\n")

                tok = outer.tokenizer

                def send_delta(delta: str):
                    if chat:
                        d = {"delta": {"content": delta}, "index": 0,
                             "finish_reason": None}
                    else:
                        d = {"text": delta, "index": 0,
                             "finish_reason": None}
                    ev = {"id": f"cmpl-{req.id}",
                          "object": "chat.completion.chunk" if chat
                          else "text_completion",
                          "model": outer.model_name, "choices": [d]}
                    chunk(f"data: {json.dumps(ev)}\n\n".encode())

                emitted = 0
                sent_text = ""
                # byte-exact streaming for byte-level tokenizers: feed
                # ONLY the new bytes of each token through an
                # incremental UTF-8 decoder (final=False), so a
                # codepoint split across tokens stays buffered in the
                # decoder until its last byte arrives — it is never
                # flushed as U+FFFD and re-sent. A tail left
                # incomplete at EOS is dropped cleanly (it never
                # formed a character). Tokenizers without a raw byte
                # view (HF) keep the rstrip heuristic below.
                decode_bytes = getattr(tok, "decode_bytes", None)
                if decode_bytes is not None:
                    dec = codecs.getincrementaldecoder("utf-8")(
                        "replace")
                    sent_bytes = 0
                while True:
                    t = req.stream.get()
                    last = t is None
                    if not last:
                        emitted += 1
                    if decode_bytes is not None:
                        data = decode_bytes(req.output_ids[:emitted])
                        delta = dec.decode(data[sent_bytes:], False)
                        sent_bytes = len(data)
                        if delta:
                            send_delta(delta)
                        if last:
                            break
                        continue
                    full = tok.decode(req.output_ids[:emitted])
                    if last:
                        stable = full  # flush everything at EOS
                    else:
                        # hold back trailing replacement chars — they are
                        # usually a multi-byte char split across tokens
                        # that the next token will complete
                        stable = full.rstrip("�")
                    if not stable.startswith(sent_text):
                        sent_text = ""  # re-sync (should not happen)
                    delta, sent_text = stable[len(sent_text):], stable
                    if delta:
                        send_delta(delta)
                    if last:
                        break
                # the terminal event carries usage (OpenAI
                # include_usage shape) so clients can count output
                # tokens authoritatively — text deltas undercount
                # when a token contributes no complete codepoint
                done = {"id": f"cmpl-{req.id}", "choices": [{
                    "index": 0,
                    "delta" if chat else "text": {} if chat else "",
                    "finish_reason": req.finish_reason}],
                    "usage": {
                        "prompt_tokens": len(req.prompt_ids),
                        "completion_tokens": len(req.output_ids),
                        "total_tokens": len(req.prompt_ids)
                        + len(req.output_ids)}}
                chunk(f"data: {json.dumps(done)}\n\n".encode())
                chunk(b"data: [DONE]\n\n")
                chunk(b"")  # terminal chunk

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def _adapter_names(self):
        eng = getattr(self.scheduler, "engine", None)
        return list(getattr(eng, "adapter_names", []) or [])

    def _note_prefix(self, payload: dict) -> None:
        """Record the prefix digest of an admitted request (bounded
        LRU) — the same digest the router computes from the same
        payload, so directory lookups land on the replicas that
        actually hold the prefix KV."""
        if not self._report_prefixes:
            return
        key = affinity_from_payload(payload)
        if not key:
            return
        d = prefix_digest(key)
        with self._prefix_digest_lock:
            self._prefix_digests.pop(d, None)
            self._prefix_digests[d] = True
            while len(self._prefix_digests) > self._prefix_digest_cap:
                self._prefix_digests.popitem(last=False)

    def prefix_digests(self) -> list:
        with self._prefix_digest_lock:
            return list(self._prefix_digests)

    def _retry_after(self, default: float = 1.0) -> str:
        """Retry-After derived from the scheduler's live queue-wait
        estimate (clamped to [1, 30]s) rather than a hardcoded guess —
        a saturated queue tells clients to back off for as long as it
        will actually take to drain."""
        hint = getattr(self.scheduler, "retry_after_hint", None)
        if callable(hint):
            try:
                return str(hint(default))
            except Exception:
                pass
        return _retry_after_str(default)

    def _log_request(self, req: Request, outcome: Optional[str] = None):
        """One JSONL record per finished (or rejected) request — the
        engine half of the request-lifecycle trace; the router writes
        the matching record with the same trace id."""
        if not self.request_log.enabled:
            return
        end = req.finished_at if req.finished_at is not None \
            else time.monotonic()

        def _delta(a, b):
            return round(b - a, 6) if a is not None and b is not None \
                else None

        n = len(req.output_ids)
        tpot = None
        if req.first_token_at is not None and n > 1:
            tpot = round((end - req.first_token_at) / (n - 1), 6)
        # schema v3 (docs/autoscaling.md): v2 plus the priority class,
        # so per-class SLO replay does not have to re-derive tenancy.
        # The ADMIT instant is on both clocks — req.created is
        # monotonic, so the wall-clock half is recovered by rebasing
        # against now. Trace replay reconstructs inter-arrival gaps
        # from these instead of finish times.
        now_mono = time.monotonic()
        self.request_log.write({
            "component": "engine",
            "trace_id": getattr(req.trace, "trace_id", None),
            "span_id": getattr(req.trace, "span_id", None),
            "request_id": req.id,
            "admit_ts": round(time.time() - (now_mono - req.created),
                              6),
            "admit_mono": round(req.created, 6),
            "model": self.model_name,
            "adapter": req.adapter,
            "class": req.priority,
            "queue_wait_s": _delta(req.created, req.scheduled_at),
            "ttft_s": _delta(req.created, req.first_token_at),
            "tpot_s": tpot,
            "e2e_s": round(end - req.created, 6),
            "prompt_tokens": len(req.prompt_ids),
            "output_tokens": n,
            "finish_reason": outcome or req.finish_reason,
        })

    def begin_drain(self):
        """Flip this replica to draining: /ready answers 503 (the
        router health loop stops selecting it), new work answers 503
        with the X-OME-Draining marker, in-flight requests keep
        streaming. The HTTP server stays up for the whole grace
        window — clients mid-stream must be able to finish."""
        self.draining = True
        drain = getattr(self.scheduler, "begin_drain", None)
        if drain is not None:
            drain()

    def start(self):
        self.scheduler.start()
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        name="ome-http", daemon=True)
        self._thread.start()

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.scheduler.stop()
        if self._thread:
            self._thread.join(timeout=5)
        self.request_log.close()
        # after the scheduler's last op: a tp group's teardown (serve)
        for fn in self.on_stop:
            fn()
