"""Performance attribution of the port (ome_tpu_torch/perf) against the
reference's (ome_tpu/perf).

The program cost ledger: the JAX InferenceEngine and the port's run the
same op script (prefills at two buckets, a suffix prefill after a
prefix hit, a masked prefill, inserts, decodes plain and masked,
decode_multi and verify, dense and paged) with both ledgers in "model"
mode; the two snapshots list the same program keys in the same order,
with the same dispatch counts and the same flops, bytes and expected ms
(1e-9 relative). Two schedulers bind the ledgers and export equal
`ome_engine_program_{flops,bytes}` families. "full" mode on the CPU
counts one decode step's products exactly (the ledger's counter over
the plain versions); that counter gives every program of the script
(dense, paged, MoE) the FLOPs torch's FlopCounterMode gives, and
counting imports no torch._dynamo.

Then the reference's tests/test_perf.py cases, each on the port: ledger
unit behavior, the /debug/programs surface (403, 404, schema), the HBM
partition arithmetic, its tenant-model fallback and peak watermark,
`for_engine` on fakes and on real engines (the kv_cache tenant equal to
the reference's for dense, paged bf16 and paged int8 engines), the
slow-step detector (its event names the program), the online roofline
gauges, and the profiler's off-card answer and 409 on a concurrent
capture.
"""

import json
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ome_tpu.engine.core import InferenceEngine as JaxEngine
from ome_tpu.engine.scheduler import Scheduler as JaxScheduler
from ome_tpu.models import llama as jllama
from ome_tpu.models.config import tiny_test as jax_tiny
from ome_tpu.perf import ProgramLedger as JaxLedger
from ome_tpu.perf import HbmAccountant as JaxHbm
from ome_tpu_torch import faults
from ome_tpu_torch.engine.core import InferenceEngine
from ome_tpu_torch.engine.scheduler import Request, Scheduler
from ome_tpu_torch.engine.server import EngineServer
from ome_tpu_torch.engine.tokenizer import ByteTokenizer
from ome_tpu_torch.models.config import tiny_test
from ome_tpu_torch.models.params import from_jax_params
from ome_tpu_torch.perf import (HBM_TENANTS, HbmAccountant, ProgramLedger,
                                device_spec, roofline_ms)
from ome_tpu_torch.telemetry import Registry, profiler
from ome_tpu_torch.telemetry.flight import FlightRecorder

SLOTS, MAX_SEQ, BLOCK = 4, 128, 16
PC_BYTES = 64 << 20
REL = 1e-9
GREEDY = (np.zeros(SLOTS, np.float32), np.zeros(SLOTS, np.int32),
          np.ones(SLOTS, np.float32))


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset()
    yield
    faults.reset()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    jcfg = jax_tiny().replace(dtype=jnp.float32)
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), "cpu")
    tcfg = tiny_test().replace(dtype=torch.float32)
    return jcfg, jparams, tcfg, tparams


def _engines(world, ledger_mode="model", **kw):
    jcfg, jparams, tcfg, tparams = world
    jeng = JaxEngine(jparams, jcfg, max_slots=SLOTS, max_seq=MAX_SEQ,
                     prefix_cache_bytes=PC_BYTES,
                     ledger=JaxLedger(mode=ledger_mode), **kw)
    teng = InferenceEngine(tparams, tcfg, max_slots=SLOTS, max_seq=MAX_SEQ,
                           prefix_cache_bytes=PC_BYTES, device="cpu",
                           ledger=ProgramLedger(mode=ledger_mode), **kw)
    return jeng, teng


def _prompt(seed, n):
    return [int(t) for t in np.random.default_rng(seed).integers(3, 500, n)]


def _script(eng, paged: bool):
    """The op script both engines run; returns nothing (the ledgers are
    what is compared)."""
    V = eng.cfg.vocab_size
    state = eng.new_state()
    shared = _prompt(1, 40)
    first = [True] + [False] * (V - 1)
    for slot, ids in enumerate((shared + _prompt(2, 10),   # bucket 64
                                _prompt(3, 90),            # bucket 128
                                shared + _prompt(4, 30))):  # suffix hit
        tok, kv, n, bucket = eng.prefill(ids)
        state = eng.insert(state, kv, slot, n, tok, bucket)
    if not paged:
        tok, kv, n, bucket = eng.prefill(_prompt(5, 20),
                                         first_mask=np.asarray(first))
        state = eng.insert(state, kv, 3, n, tok, bucket)
    for _ in range(2):
        state, _ = eng.decode(state, *GREEDY)
    mask = np.ones((SLOTS, V), bool)
    state, _ = eng.decode(state, *GREEDY, mask=mask)
    if not paged:
        state, _ = eng.decode(state, *GREEDY,
                              mask_idx=np.zeros(SLOTS, np.int32))
    budget = np.full(SLOTS, 8, np.int32)
    stops = np.full((SLOTS, 1), -1, np.int32)
    state, _, _ = eng.decode_multi(state, *GREEDY, steps=2, budget=budget,
                                   stop_ids=stops)
    drafts = np.asarray([_prompt(10 + s, 2) for s in range(SLOTS)],
                        np.int32)
    state, _, _ = eng.verify(state, drafts, np.full(SLOTS, 2, np.int32),
                             *GREEDY)
    state, _ = eng.decode(state, *GREEDY)


def _close(a, b) -> bool:
    return abs(a - b) <= REL * max(abs(a), abs(b))


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_model_ledger_equals_reference(world, paged):
    kw = dict(kv_block=BLOCK) if paged else {}
    jeng, teng = _engines(world, **kw)
    _script(jeng, paged)
    _script(teng, paged)
    want, got = jeng.ledger.snapshot(), teng.ledger.snapshot()
    assert [e["program"] for e in got] == [e["program"] for e in want]
    assert any(e["name"] == "prefill_suffix" for e in got)
    for w, g in zip(want, got):
        assert g["dispatches"] == w["dispatches"], g["program"]
        assert g["source"] == w["source"] == "model"
        for field in ("flops", "bytes", "expected_ms"):
            assert _close(g[field], w[field]), (g["program"], field,
                                                g[field], w[field])


def _families(registry, names):
    return sorted(line for line in registry.render().splitlines()
                  if line.split("{", 1)[0] in names)


def test_scheduler_gauges_equal_reference(world):
    jeng, teng = _engines(world)
    jsched, tsched = JaxScheduler(jeng), Scheduler(teng)
    for sched in (jsched, tsched):
        req = Request(id="r1", prompt_ids=_prompt(7, 30), max_new_tokens=6)
        sched.submit(req)
        deadline = time.monotonic() + 120
        while not req.done.is_set() and time.monotonic() < deadline:
            sched.step()
        assert req.done.is_set()
    names = ("ome_engine_program_flops", "ome_engine_program_bytes")
    want = _families(jsched.registry, names)
    got = _families(tsched.registry, names)
    assert got == want and len(got) >= 4


def test_full_mode_counts_one_decode_step(world):
    """One dense decode step under "full" on the CPU: the products of
    every layer (q/k/v/o, gate/up/down), the plain attention's two
    products over the whole [B, S] slab, and the lm head."""
    _, _, tcfg, tparams = world
    led = ProgramLedger(mode="full")
    eng = InferenceEngine(tparams, tcfg, max_slots=SLOTS, max_seq=MAX_SEQ,
                          device="cpu", ledger=led)
    state = eng.new_state()
    state, _ = eng.decode(state, *GREEDY)
    (entry,) = led.snapshot()
    c, B, S = tcfg, SLOTS, MAX_SEQ
    D, H, K, Dh, I, V = (c.hidden_size, c.num_heads, c.num_kv_heads,
                         c.head_dim, c.intermediate_size, c.vocab_size)

    def mm(m, n, k):
        return 2 * m * n * k
    per_layer = (mm(B, H * Dh, D) + 2 * mm(B, K * Dh, D)
                 + mm(B, D, H * Dh) + 2 * mm(B, I, D) + mm(B, D, I)
                 + 2 * B * H * mm(1, S, Dh))
    want = c.num_layers * per_layer + mm(B, V, D)
    assert entry["source"] == "counted"
    assert entry["flops"] == want
    # the modelled bytes and the counted argument/output bytes
    assert entry["bytes"] == eng._cost_model(B, B * S)["bytes"]
    assert entry["argument_bytes"] > eng.weight_bytes()
    assert entry["output_bytes"] == B * 4  # the [B] int32 tokens
    assert entry["expected_ms"] > 0


def test_auto_mode_is_model_on_the_cpu(world):
    _, _, tcfg, tparams = world
    eng = InferenceEngine(tparams, tcfg, max_slots=SLOTS, max_seq=MAX_SEQ,
                          device="cpu")
    assert eng.ledger.mode == "auto"
    eng.decode(eng.new_state(), *GREEDY)
    (entry,) = eng.ledger.snapshot()
    assert entry["source"] == "model" and entry["device"] == "cpu"


class _TorchFlopCounterMode:
    """torch's FlopCounterMode behind the ledger counter's interface."""

    def __enter__(self):
        from torch.utils.flop_counter import FlopCounterMode
        self.mode = FlopCounterMode(display=False)
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self.mode.__exit__(*exc)

    @property
    def flops(self):
        return self.mode.get_total_flops()


@pytest.mark.parametrize("kind", ["dense", "paged", "moe"])
def test_ledger_counter_counts_as_flop_counter_mode(world, kind,
                                                    monkeypatch):
    """The ledger's own counter (perf/ledger.py::FlopCounter) gives every
    program of the op script the FLOPs torch's FlopCounterMode gives."""
    from ome_tpu_torch.perf import ledger as ledger_mod
    _, _, tcfg, tparams = world
    kw = {"kv_block": BLOCK} if kind == "paged" else {}
    if kind == "moe":
        tcfg = tiny_test(moe=True).replace(dtype=torch.float32,
                                           num_layers=2)
        jp = jllama.init_params(jax.random.PRNGKey(1), jax_tiny(
            moe=True).replace(dtype=jnp.float32, num_layers=2))
        tparams = from_jax_params(jax.tree.map(np.asarray, jp), "cpu")

    def counted():
        led = ProgramLedger(mode="full")
        eng = InferenceEngine(tparams, tcfg, max_slots=SLOTS,
                              max_seq=MAX_SEQ, prefix_cache_bytes=PC_BYTES,
                              device="cpu", ledger=led, **kw)
        _script(eng, paged=kind == "paged")
        return {e["program"]: (e["source"], e["flops"])
                for e in led.snapshot()}
    got = counted()
    monkeypatch.setattr(ledger_mod, "FlopCounter", _TorchFlopCounterMode)
    want = counted()
    assert got == want
    assert all(src == "counted" and flops > 0
               for src, flops in got.values())


def test_ledger_counting_imports_no_dynamo():
    """Counting a program imports no torch._dynamo (FlopCounterMode's
    first use does: seconds of every new engine process on the card)."""
    import subprocess
    import sys
    code = (
        "import sys, torch\n"
        "from ome_tpu_torch.perf.ledger import ProgramLedger\n"
        "led = ProgramLedger(mode='full', device='cpu')\n"
        "led.prepare()\n"
        "x = torch.ones(8, 8)\n"
        "led.capture('mm', '', lambda: x @ x, (x,), "
        "{'flops': 0.0, 'bytes': 0.0})\n"
        "assert led.last_dispatch()['flops'] == 2 * 8 ** 3\n"
        "assert 'torch._dynamo' not in sys.modules\n"
        "print('ok')\n")
    import pathlib
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       cwd=str(pathlib.Path(__file__).resolve().parents[1]))
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


# -- the reference's ledger unit cases ---------------------------------


class TestLedger:
    def test_bad_mode_rejected(self):
        with pytest.raises(ValueError, match="ledger mode"):
            ProgramLedger(mode="bogus")

    def test_roofline_is_max_of_memory_and_compute(self):
        assert roofline_ms(1e9, 1e9, 100.0, 100.0) == pytest.approx(10.0)
        assert roofline_ms(1e12, 1e3, 100.0, 1.0) == pytest.approx(1000.0)

    def test_device_spec_off_the_card(self):
        spec = device_spec("cpu")
        assert spec["platform"] == "cpu"
        assert spec["hbm_gbps"] > 0 and spec["peak_tflops"] > 0

    def test_h100_row_and_cuda_fallback(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda d=None: "NVIDIA H100 80GB HBM3")
        spec = device_spec("cuda")
        assert (spec["platform"], spec["hbm_gbps"],
                spec["peak_tflops"]) == ("gpu", 3350.0, 989.0)
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda d=None: "Some Future Card")
        assert device_spec("cuda")["hbm_gbps"] == 3350.0

    def test_capture_model_fallback(self):
        led = ProgramLedger(mode="auto", device="cpu")
        assert led.capture("decode", "", lambda: 7, (),
                           {"flops": 2e9, "bytes": 1e8}) == 7
        entry = led.last_dispatch()
        assert entry["source"] == "model"
        assert entry["flops"] == 2e9 and entry["bytes"] == 1e8
        assert entry["expected_ms"] > 0
        assert len(led) == 1

    def test_capture_full_counts_and_repeats_only_bump(self):
        x = torch.ones(64, 64)
        led = ProgramLedger(mode="full")
        led.capture("matmul", "", lambda: x @ x, (x, x),
                    {"flops": 1.0, "bytes": 1.0})
        entry = led.last_dispatch()
        assert entry["source"] == "counted"
        assert entry["flops"] == 2 * 64 ** 3
        assert entry["bytes"] == 1.0  # modelled, never counted
        assert entry["argument_bytes"] == 64 * 64 * 4  # x once
        assert entry["output_bytes"] == 64 * 64 * 4
        led.capture("matmul", "", lambda: x @ x, (x, x),
                    {"flops": 1.0, "bytes": 1.0})
        assert led.last_dispatch() is entry and entry["dispatches"] == 2

    def test_kernel_flops_join_the_count(self):
        from ome_tpu_torch.ops import flash
        led = ProgramLedger(mode="full")

        def dispatch():  # a kernel launch reports its own FLOPs
            flash._report_flops(lambda: torch.tensor(1000))
            assert flash._FLOP_SINK.sink
            return torch.ones(2, 2) @ torch.ones(2, 2)
        led.capture("k", "", dispatch, (), {"flops": 0.0, "bytes": 0.0})
        assert led.last_dispatch()["flops"] == 1000 + 2 * 2 ** 3

    def test_dispatch_error_propagates(self):
        led = ProgramLedger(mode="full")

        def boom():
            raise KeyError("dispatch")
        with pytest.raises(KeyError):
            led.capture("x", "", boom, (), {"flops": 1.0, "bytes": 1.0})
        assert len(led) == 0

    def test_static_desc_splits_entries(self):
        led = ProgramLedger(mode="model")
        led.capture("decode_multi", "n=4", lambda: None, (),
                    {"flops": 1.0, "bytes": 1.0})
        led.capture("decode_multi", "n=8", lambda: None, (),
                    {"flops": 2.0, "bytes": 2.0})
        assert [e["program"] for e in led.snapshot()] == \
            ["decode_multi[n=4]", "decode_multi[n=8]"]

    def test_off_mode_captures_nothing(self):
        led = ProgramLedger(mode="off")
        assert led.capture("decode", "", lambda: 3, (),
                           {"flops": 1.0, "bytes": 1.0}) == 3
        assert len(led) == 0 and led.last_dispatch() is None

    def test_bind_exports_retroactively(self):
        led = ProgramLedger(mode="model")
        led.capture("decode", "", lambda: None, (), {"flops": 5.0, "bytes": 7.0})
        reg, fl = Registry(), FlightRecorder()
        led.bind(reg, fl)
        assert reg.get("ome_engine_program_flops", program="decode") == 5.0
        assert reg.get("ome_engine_program_bytes", program="decode") == 7.0
        led.capture("prefill", "bucket=64", lambda: None, (),
                    {"flops": 3.0, "bytes": 4.0})
        assert reg.get("ome_engine_program_flops",
                       program="prefill[bucket=64]") == 3.0
        assert "program_captured" in [e["event"] for e in fl.snapshot(10)]

    def test_summary_shape(self):
        led = ProgramLedger(mode="model")
        led.capture("decode", "", lambda: None, (), {"flops": 1.0, "bytes": 1.0})
        (row,) = led.summary()
        assert set(row) == {"program", "expected_ms", "source"}

    def test_engine_builds_default_ledger(self, world):
        _, _, tcfg, tparams = world
        eng = InferenceEngine(tparams, tcfg, max_slots=2, max_seq=64,
                              device="cpu")
        assert isinstance(eng.ledger, ProgramLedger)
        assert eng.ledger.mode == "auto"
        assert eng.ledger.device == torch.device("cpu")


# -- /debug/programs and /debug/profile --------------------------------


class FakeEngine:
    """Minimal engine double (no device work): token 3 every step."""

    max_seq = 1024

    def __init__(self, max_slots=1, decode_s=0.0):
        self.max_slots = max_slots
        self.decode_s = decode_s

    def new_state(self):
        return "s"

    def prefill(self, ids, t, k, p):
        return 1, "kv", len(ids), 16

    def insert(self, state, kv, slot, true_len, token, bucket):
        return state

    def free_slot(self, slot):
        pass

    def decode(self, state, t, k, p):
        if self.decode_s:
            time.sleep(self.decode_s)
        return state, np.full(self.max_slots, 3, np.int32)


def _call(url, method="GET"):
    req = urllib.request.Request(url, method=method,
                                 data=b"{}" if method == "POST" else None)
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, dict(r.headers), json.loads(r.read())
    except urllib.error.HTTPError as e:
        with e:
            return e.code, dict(e.headers), json.loads(e.read())


def _serving(sched, **kw):
    srv = EngineServer(sched, tokenizer=ByteTokenizer(), model_name="t",
                       port=0, **kw)
    srv.start()
    return srv, f"http://127.0.0.1:{srv.port}"


class TestDebugPrograms:
    def test_403_when_disabled(self):
        srv, url = _serving(Scheduler(FakeEngine()))
        try:
            status, _, body = _call(url + "/debug/programs")
            assert status == 403 and "--debug-endpoints" in body["error"]
        finally:
            srv.stop()

    def test_404_without_ledger(self):
        srv, url = _serving(Scheduler(FakeEngine()), debug_endpoints=True)
        try:
            assert _call(url + "/debug/programs")[0] == 404
        finally:
            srv.stop()

    def test_schema_when_enabled(self):
        eng = FakeEngine()
        eng.ledger = ProgramLedger(mode="model", device="cpu")
        sched = Scheduler(eng)  # binds the ledger to its registry
        eng.ledger.capture("decode", "", lambda: None, (),
                           {"flops": 2e9, "bytes": 1e8})
        srv, url = _serving(sched, debug_endpoints=True)
        try:
            status, _, doc = _call(url + "/debug/programs")
            assert status == 200
            assert doc["mode"] == "model" and doc["count"] == 1
            assert doc["device"]["platform"] == "cpu"
            (entry,) = doc["programs"]
            assert entry["program"] == "decode"
            for field in ("flops", "bytes", "expected_ms", "source",
                          "dispatches"):
                assert field in entry
        finally:
            srv.stop()


class TestProfile:
    def test_off_card_response_carries_programs(self, tmp_path):
        led = ProgramLedger(mode="model")
        led.capture("decode", "", lambda: None, (), {"flops": 1.0, "bytes": 1.0})
        result = profiler.capture(str(tmp_path), 0.1, ledger=led)
        assert result["captured"] is False
        assert result["programs"][0]["program"] == "decode"
        with pytest.raises(ValueError):
            profiler.capture(str(tmp_path), 61)

    def test_statuses(self, tmp_path, monkeypatch):
        """403 without --profile-dir; 400 for bad seconds; 409 with
        Retry-After while another session holds the profiler (on a card:
        `is_available` faked, the session held on the CPU); 200 off the
        card."""
        srv, url = _serving(Scheduler(FakeEngine()))
        try:
            assert _call(url + "/debug/profile", "POST")[0] == 403
        finally:
            srv.stop()
        srv, url = _serving(Scheduler(FakeEngine()),
                            profile_dir=str(tmp_path))
        try:
            assert _call(url + "/debug/profile?seconds=0", "POST")[0] == 400
            assert _call(url + "/debug/profile?seconds=x", "POST")[0] == 400
            status, _, body = _call(url + "/debug/profile?seconds=0.1",
                                    "POST")
            assert status == 200 and body["captured"] is False
            from torch.profiler import ProfilerActivity
            with profiler.session([ProfilerActivity.CPU]):
                with pytest.raises(profiler.ProfileInProgress):
                    with profiler.session([ProfilerActivity.CPU]):
                        pass
                monkeypatch.setattr(torch.cuda, "is_available",
                                    lambda: True)
                status, headers, _ = _call(
                    url + "/debug/profile?seconds=0.1", "POST")
            assert status == 409 and headers["Retry-After"] == "1"
        finally:
            srv.stop()


# -- HBM accounting ----------------------------------------------------


class TestHbm:
    def test_partition_arithmetic(self):
        reg = Registry()
        acc = HbmAccountant(
            reg, weight_bytes=1000, flight=None,
            stats_fn=lambda: {"bytes_in_use": 5000, "bytes_limit": 16000,
                              "peak_bytes_in_use": 6000})
        part = acc.update(engine=None)
        assert part["weights"] == 1000
        assert part["kv_cache"] == 0 and part["prefix_cache"] == 0
        assert part["workspace"] == 4000
        assert part["bytes_in_use"] == 5000
        assert reg.get("ome_engine_hbm_bytes_in_use") == 5000
        assert reg.get("ome_engine_hbm_bytes_limit") == 16000
        assert reg.get("ome_engine_hbm_peak_bytes") == 6000
        assert reg.get("ome_engine_hbm_tenant_bytes",
                       tenant="workspace") == 4000
        for t in HBM_TENANTS:
            assert reg.get("ome_engine_hbm_tenant_bytes",
                           tenant=t) is not None

    def test_no_stats_falls_back_to_tenant_model(self):
        acc = HbmAccountant(Registry(), weight_bytes=1234,
                            stats_fn=lambda: None)
        part = acc.update(engine=None)
        assert part["bytes_in_use"] == 1234 and part["workspace"] == 0
        # a CPU device has no allocator numbers either
        part = HbmAccountant(Registry(), weight_bytes=99,
                             device="cpu").update()
        assert part["bytes_in_use"] == 99 and part["bytes_limit"] == 0

    def test_peak_watermark_event(self):
        fl = FlightRecorder()
        stats = {"bytes_in_use": 100, "peak_bytes_in_use": 100}
        acc = HbmAccountant(Registry(), weight_bytes=10, flight=fl,
                            stats_fn=lambda: dict(stats))
        acc.update()
        acc.update()
        assert not [e for e in fl.snapshot(10) if e["event"] == "hbm_peak"]
        stats["peak_bytes_in_use"] = stats["bytes_in_use"] = 150
        acc.update()
        (ev,) = [e for e in fl.snapshot(10) if e["event"] == "hbm_peak"]
        assert ev["peak_bytes"] == 150
        assert ev["weights"] == 10 and ev["workspace"] == 140

    def test_for_engine_rejects_fakes(self):
        assert HbmAccountant.for_engine(FakeEngine(), Registry()) is None

    @pytest.mark.parametrize("kv", [{}, {"kv_block": BLOCK},
                                    {"kv_block": BLOCK, "kv_dtype": "int8"}],
                             ids=["dense", "paged", "paged_int8"])
    def test_for_engine_kv_tenant_equals_reference(self, world, kv):
        jeng, teng = _engines(world, **kv)
        want = JaxHbm.for_engine(jeng, Registry()).update(jeng)
        got = HbmAccountant.for_engine(teng, Registry()).update(teng)
        assert got["kv_cache"] == want["kv_cache"] > 0
        assert got["weights"] == want["weights"] > 0
        assert got["bytes_in_use"] == want["bytes_in_use"]


# -- slow steps and the online roofline --------------------------------


class StallEngine(FakeEngine):
    """FakeEngine with a ledger, whose decode stalls when an armed
    `fake_decode` fault rule says so."""

    def __init__(self):
        super().__init__()
        self.ledger = ProgramLedger(mode="model", device="cpu")

    def decode(self, state, t, k, p):
        faults.fire("fake_decode")
        return self.ledger.capture(
            "decode", "", lambda: (state, np.full(1, 3, np.int32)), (),
            {"flops": 1.0, "bytes": 1e3})


class TestSlowStep:
    def test_injected_stall_records_program(self):
        faults.install("fake_decode.slow=0.08@40")
        sched = Scheduler(StallEngine())
        req = Request(id="r1", prompt_ids=[1, 2], max_new_tokens=50)
        sched.submit(req)
        deadline = time.monotonic() + 30
        while not req.done.is_set() and time.monotonic() < deadline:
            sched.step()
        assert req.done.is_set()
        events = [e for e in sched.flight.snapshot(256)
                  if e["event"] == "slow_step"]
        assert events, "stalled step never flagged"
        ev = max(events, key=lambda e: e["step_ms"])
        for field in ("step_ms", "median_ms", "ratio", "k_steps",
                      "mask_ms", "gap_ms", "program", "expected_ms"):
            assert field in ev
        assert ev["program"] == "decode"
        assert ev["ratio"] > 4.0 and ev["step_ms"] >= 80.0
        assert sched.registry.get("ome_engine_slow_steps_total") >= 1


class TestRooflineOnline:
    def test_scheduler_exports_roofline_gauges(self, world):
        _, _, tcfg, tparams = world
        eng = InferenceEngine(tparams, tcfg, max_slots=2, max_seq=64,
                              device="cpu",
                              ledger=ProgramLedger(mode="model"))
        sched = Scheduler(eng)
        req = Request(id="r1", prompt_ids=[1, 2, 3], max_new_tokens=8)
        sched.submit(req)
        deadline = time.monotonic() + 120
        while not req.done.is_set() and time.monotonic() < deadline:
            sched.step()
        assert req.done.is_set()
        R = sched.registry
        assert R.get("ome_engine_roofline_efficiency") > 0
        assert R.get("ome_engine_step_achieved_gbps") > 0
        assert R.get("ome_engine_roofline_step_efficiency") > 0
        sched.update_gauges()
        assert R.get("ome_engine_hbm_bytes_in_use") > 0
        assert R.get("ome_engine_hbm_tenant_bytes",
                     tenant="weights") == eng.weight_bytes()
