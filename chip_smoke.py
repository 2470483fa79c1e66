"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives `ome_tpu_torch` only (never JAX, never `ome_tpu`):

1. device: the card's name and power limit, TF32 off;
2. build: the hand-written CUDA kernels, compiled from `ome_tpu_torch/ops/
   csrc/` with nvcc for sm_90a (one nvcc per source, in parallel);
3. kernels: each kernel against its plain PyTorch version (fp32, same
   inputs) at the Llama-3-8B attention shapes, in bf16 and fp32, with the
   kernel's median time, the plain version's, the card's lower bound for
   the same work and, as a yardstick only, one
   `scaled_dot_product_attention` call. The paged decode kernel (B3)
   runs over a bf16, an fp32 and an int8 pool (random block table) and
   with a free slot's all-trash table row; the int8 dense decode (B5)
   runs on the same kernel; the int4 weight-only matmul (B4) runs at
   the 8B projection shapes, beside `_weight_int4pack_mm` and a bf16
   `torch.mm` over the dequantized weight as yardsticks;
4. serve: the OpenAI HTTP server from `ome_tpu_torch.engine.serve.
   build_server` at the Llama-3-8B shape (random bf16 weights from a
   seed), answering concurrent completions, a stream, a prefix-cache hit
   and a repeated prompt, with the kernel launch counters read around it;
   then the engine's decode and prefill step times;
5. paged bf16: the same server with `--kv-block 128 --max-slots 16
   --kv-blocks 129` (a quarter of the dense-equivalent pool): concurrent
   completions filling 3/4 of the pool, twins, a burst larger than the
   pool (admission backpressure, preemption), the pool conserved at
   idle, B3 launched and B1 not;
6. paged int8: `--kv-dtype int8` with the same seed: first tokens equal
   the bf16 server's, B3's int8 branch launched, pool conserved;
7. serve int4: the dense server again with `--quantization int4`
   (weights quantized at load): the same requests, B4 launched by its
   decode steps and short prefills, a prompt over 256 tokens through the
   dequantizing route; weight bytes, memory and step times;
8. step times: the dense, paged bf16 and paged int8 engines' decode
   steps over one set of weights, timed in turns;
9. weight quantization: the bf16, int8, fp8 and int4 engines over one
   weight set, decode steps timed in turns, each quantized engine's
   greedy drift from bf16, and the int4 engine's logits held against a
   twin whose int4 weights are dequantized to bf16 (B4 end to end);
10. stream identity: fp32 at the Llama-3-8B widths, 4 layers, through
   the engine API: dense decode (B1) and paged decode over fp32 pools
   (B3) give identical 32-token greedy streams; the int8 pool's drift
   from the fp32 pool over the same streams is reported.

Prints one `{"kernels": [...]}` line, then the card's name and power limit,
then `{"ok": true, "device": {...}}` as the last line. Any failed phase
exits non-zero without that line. Longer per-case results go to
`chiprun_out/chip_smoke.json`.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_FLOPS = {"bf16": 989e12,      # dense tensor-core bf16
              "fp32": 67e12}       # fp32 outside the tensor cores
ATOL = {"bf16": 2e-2, "fp32": 2e-4}
OUT_DIR = "chiprun_out"


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# -- timing -------------------------------------------------------------------


class Timer:
    """Median device time of a kernel-sized callable, L2 flushed before
    each run.

    Each run is queued behind a spin kernel (`torch.cuda._sleep`, ~2 ms
    at H100 clocks) that outlasts the host's enqueueing of the callable,
    so the start event fires with the callable's kernels already
    queued: the events time the device work, not the Python that
    launches it. (A callable that waits on the host inside would wait
    for the spin too; whole engine steps are timed with the profiler.)"""

    SPIN_CYCLES = 4_000_000

    def __init__(self, torch, device):
        self.torch = torch
        # larger than the H100's 50 MB L2: written between timed runs so
        # each run reads its inputs from device memory, as a decode step
        # reading one layer's cache does
        self.flush_buf = torch.empty(96 << 20, dtype=torch.uint8,
                                     device=device)

    def ms(self, fn, iters: int = 15, warmup: int = 2) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(iters):
            self.flush_buf.zero_()
            torch.cuda._sleep(self.SPIN_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


# -- phase 1: device ------------------------------------------------------------


def phase_device(torch):
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a "
             "CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] nvidia-smi: {card}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    log(f"[device] matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    return card


# -- phase 2: build -------------------------------------------------------------


def phase_build():
    from ome_tpu_torch.ops import _build
    secs = _build.build()
    log(f"[build] nvcc sm_90a build of {sorted(_build.SOURCES)}: "
        f"{secs:.1f} s")
    for name, text in sorted(_build.build_logs.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    return secs


# -- phase 3: kernels against their plain versions -----------------------------


def _inputs(torch, gen, B, Sq, S, H, K, D, dtype, device):
    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=device,
                           dtype=torch.float32).to(dtype)
    return randn(B, Sq, H, D), randn(B, S, K, D), randn(B, S, K, D)


def _sdpa(torch, q, k, v, mask):
    """One scaled_dot_product_attention call computing the same
    function (yardstick only; the port never calls it)."""
    F = torch.nn.functional
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

    def fn():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              enable_gqa=True)
    try:
        fn()
    except TypeError:  # torch without enable_gqa: no yardstick
        return None
    return fn


def decode_case(torch, timer, gen, dtype_name, lengths, window=None,
                softcap=None, B=8, S=4096, H=32, K=8, D=128):
    from ome_tpu_torch.ops import flash
    dev = torch.device("cuda")
    dtype = torch.bfloat16 if dtype_name == "bf16" else torch.float32
    q, k, v = _inputs(torch, gen, B, 1, S, H, K, D, dtype, dev)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    pos = (lens - 1).clamp(min=0)
    hi = torch.minimum(pos + 1, lens)
    lo = (pos - window + 1).clamp(min=0) if window else \
        torch.zeros_like(pos)
    scale = D ** -0.5
    out = flash.flash_decode(q, k, v, lo, hi, scale, softcap)
    ref = flash.flash_decode_ref(q.float(), k.float(), v.float(), lo, hi,
                                 scale, softcap)
    torch.cuda.synchronize()
    if not torch.isfinite(out.float()).all():
        fail(f"flash_decode {dtype_name}: non-finite output")
    err = (out.float() - ref).abs().max().item()
    ms = timer.ms(lambda: flash.flash_decode(q, k, v, lo, hi, scale,
                                             softcap))
    plain_ms = timer.ms(lambda: flash.flash_decode_ref(
        q.float(), k.float(), v.float(), lo, hi, scale, softcap), iters=5)
    lib_ms = None
    if not softcap:
        col = torch.arange(S, device=dev)
        mask = ((col[None, :] >= lo[:, None]) & (col[None, :] < hi[:, None])
                )[:, None, None, :]
        fn = _sdpa(torch, q, k, v, mask)
        if fn is not None:
            lib_ms = timer.ms(fn)
    rows = int((hi - lo).clamp(min=0).sum())
    esize = q.element_size()
    nbytes = 2 * rows * K * D * esize + 2 * q.numel() * esize + 2 * B * 4
    flops = 4 * D * H * rows
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return {"case": f"decode {dtype_name} B={B} S={S} H={H} K={K} D={D} "
                    f"lengths={lengths} window={window} softcap={softcap}",
            "max_abs_err": err, "atol": ATOL[dtype_name],
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


def prefill_case(torch, timer, gen, dtype_name, Sq, S, base, window=None,
                 softcap=None, B=1, H=32, K=8, D=128):
    from ome_tpu_torch.ops import flash
    dev = torch.device("cuda")
    dtype = torch.bfloat16 if dtype_name == "bf16" else torch.float32
    q, k, v = _inputs(torch, gen, B, Sq, S, H, K, D, dtype, dev)
    base_t = torch.full((B,), base, dtype=torch.int32, device=dev)
    kv_hi = torch.full((B,), base + Sq, dtype=torch.int32, device=dev)
    scale = D ** -0.5
    out = flash.flash_prefill(q, k, v, base_t, kv_hi, scale, softcap,
                              window)
    ref = flash.flash_prefill_ref(q.float(), k.float(), v.float(), base_t,
                                  kv_hi, scale, softcap, window)
    torch.cuda.synchronize()
    if not torch.isfinite(out.float()).all():
        fail(f"flash_prefill {dtype_name}: non-finite output")
    err = (out.float() - ref).abs().max().item()
    ms = timer.ms(lambda: flash.flash_prefill(q, k, v, base_t, kv_hi,
                                              scale, softcap, window))
    plain_ms = timer.ms(lambda: flash.flash_prefill_ref(
        q.float(), k.float(), v.float(), base_t, kv_hi, scale, softcap,
        window), iters=3)
    lib_ms = None
    if not softcap:
        col = torch.arange(S, device=dev)[None, :]
        pos = (base + torch.arange(Sq, device=dev))[:, None]
        mask = (col <= pos) & (col < base + Sq)
        if window:
            mask = mask & (col > pos - window)
        fn = _sdpa(torch, q, k, v, mask[None, None])
        if fn is not None:
            lib_ms = timer.ms(fn)
    pos = base + torch.arange(Sq)
    hi = torch.clamp(pos + 1, max=base + Sq)
    lo = (pos - window + 1).clamp(min=0) if window else \
        torch.zeros_like(pos)
    pairs = int((hi - lo).clamp(min=0).sum()) * B
    flops = 4 * D * H * pairs
    esize = q.element_size()
    nbytes = (2 * q.numel() + 2 * B * (base + Sq) * K * D) * esize
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return {"case": f"prefill {dtype_name} B={B} Sq={Sq} S={S} base={base} "
                    f"H={H} K={K} D={D} window={window} softcap={softcap}",
            "max_abs_err": err, "atol": ATOL[dtype_name],
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


def _bound(nbytes, flops, dtype_name):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


def paged_case(torch, timer, gen, pool_name, lengths, trash_slot=None,
               B=8, H=32, K=8, D=128, bs=128, M=32, N=257):
    """B3 over a pool of N blocks with a random permutation table (no
    two sequences share a block; block 0 stays the trash block). A
    `trash_slot` gets an all-zero table row, as a free engine slot has,
    and a length past M * bs: its output must be finite."""
    from ome_tpu_torch.ops import flash, paged
    dev = torch.device("cuda")
    qdt = torch.float32 if pool_name == "fp32" else torch.bfloat16

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev,
                           dtype=torch.float32).to(qdt)
    q, kp, vp = randn(B, 1, H, D), randn(N, bs, K, D), randn(N, bs, K, D)
    ks = vs = None
    if pool_name == "int8":
        # the port's own quantizer; an [N, bs, K, D] pool is a
        # [B, S, K, D] slab with S = bs, so its scales come out [N, K, bs]
        kp, ks = flash.quantize_kv_block(kp)
        vp, vs = flash.quantize_kv_block(vp)
    perm = torch.randperm(N - 1, generator=gen, device=dev) + 1
    table = perm[:B * M].reshape(B, M).to(torch.int32)
    kv_len = torch.tensor(lengths, dtype=torch.int32, device=dev)
    if trash_slot is not None:
        table[trash_slot] = 0
    scale = D ** -0.5

    def kernel():
        return paged.paged_flash_decode(q, kp, vp, table, kv_len, scale,
                                        k_scale=ks, v_scale=vs)

    def plain():
        return paged.flash_paged_decode_ref(
            q.float(), kp if ks is not None else kp.float(),
            vp if vs is not None else vp.float(), table,
            torch.zeros_like(kv_len), kv_len, scale, k_scale=ks,
            v_scale=vs)
    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    if not torch.isfinite(out.float()).all():
        fail(f"flash_paged_decode {pool_name}: non-finite output")
    err = (out.float() - ref).abs().max().item()
    ms = timer.ms(kernel)
    plain_ms = timer.ms(plain, iters=5)
    rows = int(kv_len.clamp(max=M * bs).sum())
    esize = kp.element_size()
    nbytes = (2 * rows * K * D * esize + 2 * q.numel() * q.element_size()
              + B * M * 4 + B * 4)
    if ks is not None:
        nbytes += 2 * rows * K * 4
    dt = "fp32" if pool_name == "fp32" else "bf16"
    return {"case": f"paged {pool_name} B={B} H={H} K={K} D={D} bs={bs} "
                    f"M={M} N={N} lengths={lengths} trash_slot={trash_slot}",
            "max_abs_err": err, "atol": ATOL[dt], "ms": ms,
            "plain_ms": plain_ms, "library_ms": None,
            **_bound(nbytes, 4 * D * H * rows, dt)}


def quantized_case(torch, timer, gen, lengths, window=256, softcap=30.0,
                   B=8, S=4096, H=32, K=8, D=128):
    """B5: decode over a dense int8 cache quantized by the port's own
    quantize_kv_block, with a sliding window and a softcap."""
    from ome_tpu_torch.ops import flash
    dev = torch.device("cuda")
    q, k, v = _inputs(torch, gen, B, 1, S, H, K, D, torch.bfloat16, dev)
    kq, ks = flash.quantize_kv_block(k)
    vq, vs = flash.quantize_kv_block(v)
    del k, v
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    pos = (lens - 1).clamp(min=0)[:, None]
    scale = D ** -0.5
    lo, hi = flash._decode_limits(pos, lens, S, window)

    def kernel():
        return flash.flash_decode_quantized(
            q, kq, vq, ks, vs, pos, lens, sliding_window=window,
            scale=scale, logit_softcap=softcap)

    def plain():
        return flash.flash_decode_quantized_ref(
            q.float(), kq, vq, ks, vs, lo, hi, scale, softcap)
    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    if not torch.isfinite(out.float()).all():
        fail("flash_decode_quantized: non-finite output")
    err = (out.float() - ref).abs().max().item()
    ms = timer.ms(kernel)
    plain_ms = timer.ms(plain, iters=5)
    rows = int((hi - lo).clamp(min=0).sum())
    nbytes = (2 * rows * K * (D + 4) + 2 * q.numel() * q.element_size()
              + B * 4)
    return {"case": f"int8 dense B={B} S={S} H={H} K={K} D={D} "
                    f"lengths={lengths} window={window} softcap={softcap}",
            "max_abs_err": err, "atol": ATOL["bf16"], "ms": ms,
            "plain_ms": plain_ms, "library_ms": None,
            **_bound(nbytes, 4 * D * H * rows, "bf16")}


def phase_paged_kernels(torch, timer, gen):
    """B3 in its three pool dtypes and with a trash-table slot, and B5,
    each against its plain version."""
    lengths = [1, 17, 128, 300, 1023, 2049, 4095, 4096]
    cases = {"flash_paged_decode": [], "flash_decode_quantized": []}
    for pool_name in ("bf16", "fp32", "int8"):
        cases["flash_paged_decode"].append(
            paged_case(torch, timer, gen, pool_name, lengths))
    cases["flash_paged_decode"].append(paged_case(
        torch, timer, gen, "bf16", lengths[:7] + [5000], trash_slot=7))
    cases["flash_decode_quantized"].append(quantized_case(
        torch, timer, gen, [0, 1, 17, 128, 300, 1023, 2049, 4095]))
    return cases


def _int4_library(torch, qt):
    """`torch.ops.aten._weight_int4pack_mm` over the same weights
    (yardstick only; the port never calls it): the nibbles repacked
    unsigned (q + 8) by `_convert_weight_to_int4pack`, zero points 0,
    the scales in bf16 (the op takes no f32 scales). Returns
    (fn(x) -> y, None) or (None, why)."""
    from ome_tpu_torch.ops import int4_matmul
    qp2, s2, k, n, gsize = int4_matmul.flatten_qtensor(qt)
    try:
        q32 = qp2.to(torch.int32)
        v = torch.cat([(q32 << 28) >> 28, q32 >> 4], dim=0)   # [K, N]
        u = (v + 8).t().contiguous()                           # [N, K]
        w_u8 = (u[:, ::2] << 4 | u[:, 1::2]).to(torch.uint8)
        packed = torch.ops.aten._convert_weight_to_int4pack(w_u8, 8)
        sz = torch.stack([s2, torch.zeros_like(s2)], dim=2).to(
            torch.bfloat16).contiguous()                       # [K/G, N, 2]

        def fn(x):
            return torch.ops.aten._weight_int4pack_mm(x, packed, gsize, sz)
        fn(torch.zeros(1, k, dtype=torch.bfloat16, device=qp2.device))
        torch.cuda.synchronize()
        return fn, None
    except Exception as e:  # the op is missing or refuses this build
        return None, f"{type(e).__name__}: {str(e)[:200]}"


# tolerance of B4 against its plain version (fp32 output), relative to
# max |y|: fp32 output differs only in summation order; bf16 output adds
# the rounding of y to bf16 (half an ulp, at most 2^-8 of |y|) and can
# land on either side of a rounding boundary: one ulp, 2^-7 of max |y|
INT4_RTOL = {"fp32": 1e-4, "bf16": 2 ** -7}


def int4_case(torch, timer, gen, weights, name, m, K, N, out_name="bf16"):
    """B4 at one projection shape: x [m, K] bf16 (the serving dtype)
    against a [K, N] weight quantized by the port's own
    `quantize_tensor_int4` (std 0.02, as the model init), group 128;
    `weights` caches each shape's weight and yardsticks across cases."""
    from ome_tpu_torch.models.quant import quantize_tensor_int4
    from ome_tpu_torch.ops import int4_matmul
    dev = torch.device("cuda")
    key = (K, N)
    if key not in weights:
        w = torch.randn(K, N, generator=gen, device=dev,
                        dtype=torch.float32) * 0.02
        qt = quantize_tensor_int4(w, (0,), group=128)
        del w
        weights[key] = {"qt": qt, "lib": _int4_library(torch, qt),
                        "bf16": qt.dequant(torch.bfloat16)}
    entry = weights[key]
    qt = entry["qt"]
    out_dtype = torch.bfloat16 if out_name == "bf16" else torch.float32
    x = torch.randn(m, K, generator=gen, device=dev,
                    dtype=torch.float32).to(torch.bfloat16)

    def kernel():
        return int4_matmul.int4_matmul(x, qt, out_dtype)

    def plain():
        return int4_matmul.int4_matmul_ref(x, qt, torch.float32)
    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    if not torch.isfinite(out.float()).all():
        fail(f"int4_matmul {name} m={m}: non-finite output")
    err = (out.float() - ref).abs().max().item()
    atol = INT4_RTOL[out_name] * ref.abs().max().item()
    ms = timer.ms(kernel)
    plain_ms = timer.ms(plain, iters=5)
    lib_fn, lib_why = entry["lib"]
    lib_ms = lib_err = None
    if lib_fn is not None:
        lib_ms = timer.ms(lambda: lib_fn(x))
        lib_err = (lib_fn(x).float() - ref).abs().max().item()
    wb = entry["bf16"]
    bf16_mm_ms = timer.ms(lambda: torch.mm(x, wb))
    nbytes = (K // 2 * N + K // 128 * N * 4 + m * K * 2
              + m * N * out.element_size())
    return {"case": f"int4 {name} m={m} K={K} N={N} G=128 out={out_name}",
            "max_abs_err": err, "atol": atol, "ms": ms,
            "plain_ms": plain_ms, "library_ms": lib_ms,
            "library_err": lib_err, "library_why": lib_why,
            "bf16_mm_ms": bf16_mm_ms, **_bound(nbytes, 2 * m * K * N, "bf16")}


def phase_int4_kernel(torch, timer, gen):
    """B4 against its plain version at the Llama-3-8B projection shapes
    it serves (K 4096; w_gate/w_up N 14336, wq N 4096, wk/wv N 1024) at
    decode and short-prefill batch sizes; the main case, first, is
    w_gate at m = 8."""
    weights = {}
    shapes = (("w_gate", 4096, 14336), ("wq", 4096, 4096),
              ("wk", 4096, 1024))
    cases = [int4_case(torch, timer, gen, weights, "w_gate", 8, 4096,
                       14336)]
    for name, K, N in shapes:
        for m in (1, 5, 8, 16, 256):
            if (name, m) != ("w_gate", 8):
                cases.append(int4_case(torch, timer, gen, weights, name, m,
                                       K, N))
    cases.append(int4_case(torch, timer, gen, weights, "w_gate", 8, 4096,
                           14336, out_name="fp32"))
    why = weights[(4096, 14336)]["lib"][1]
    if why:
        log(f"[kernels] int4_matmul: no library_ms: "
            f"torch.ops.aten._weight_int4pack_mm failed ({why})")
    for c in cases:
        log(f"[kernels] int4_matmul {c['case']}: bf16 torch.mm over the "
            f"dequantized weight {c['bf16_mm_ms']:.4f} ms; "
            f"_weight_int4pack_mm err {c['library_err']}")
    del weights
    return {"int4_matmul": cases}


def phase_kernels(torch):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    timer = Timer(torch, torch.device("cuda"))
    lengths = [0, 1, 17, 128, 300, 1023, 2049, 4095]
    cases = {"flash_decode": [], "flash_prefill": []}
    for dt in ("bf16", "fp32"):
        cases["flash_decode"].append(
            decode_case(torch, timer, gen, dt, lengths))
    cases["flash_decode"].append(decode_case(
        torch, timer, gen, "bf16", lengths, window=256, softcap=30.0))
    for dt in ("bf16", "fp32"):
        cases["flash_prefill"].append(
            prefill_case(torch, timer, gen, dt, 2048, 2048, 0))
        cases["flash_prefill"].append(
            prefill_case(torch, timer, gen, dt, 512, 2048, 1024))
    cases["flash_prefill"].append(prefill_case(
        torch, timer, gen, "bf16", 2048, 2048, 0, window=512,
        softcap=50.0))
    cases.update(phase_paged_kernels(torch, timer, gen))
    cases.update(phase_int4_kernel(torch, timer, gen))
    bad = []
    for name, rows in cases.items():
        for c in rows:
            ok = c["max_abs_err"] <= c["atol"]
            lib = ("null" if c["library_ms"] is None
                   else f"{c['library_ms']:.4f}")
            log(f"[kernels] {name} {c['case']}: max_abs_err "
                f"{c['max_abs_err']:.3e} (tol {c['atol']:.3g}) "
                f"{'ok' if ok else 'FAIL'}; ms {c['ms']:.4f} plain_ms "
                f"{c['plain_ms']:.4f} bound_ms {c['bound_ms']:.4f} "
                f"({c['bound_by']}) library_ms {lib}")
            if not ok:
                bad.append(f"{name}: {c['case']}")
    if bad:
        fail("kernel disagrees with its plain version: " + "; ".join(bad))
    return cases


# -- phase 4: serve ---------------------------------------------------------------


def _hf_config(cfg) -> dict:
    return {"architectures": ["LlamaForCausalLM"],
            "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
            "num_hidden_layers": cfg.num_layers,
            "num_attention_heads": cfg.num_heads,
            "num_key_value_heads": cfg.num_kv_heads,
            "head_dim": cfg.head_dim,
            "intermediate_size": cfg.intermediate_size,
            "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.rms_norm_eps,
            "max_position_embeddings": cfg.max_seq_len,
            "tie_word_embeddings": cfg.tie_word_embeddings}


def _post(url: str, body: dict, timeout: float = 600):
    import urllib.request
    req = urllib.request.Request(
        url + "/v1/completions", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read()


def _completion(status, raw, max_tokens, what):
    if status != 200:
        fail(f"serve: {what}: HTTP {status}")
    doc = json.loads(raw)
    n = doc["usage"]["completion_tokens"]
    reason = doc["choices"][0]["finish_reason"]
    if not 1 <= n <= max_tokens or (n != max_tokens and reason != "stop"):
        fail(f"serve: {what}: {n} completion tokens "
             f"(max_tokens {max_tokens}, finish_reason {reason})")
    return doc


def _device_profile(torch, fn, iters: int):
    """Summed device time per call of `fn` and its five costliest
    device operations (ms per call, launches per call, name), from
    torch.profiler's CUDA activity; and on the host side, the top-level
    aten operators per call and the five with the most self CPU time
    (ms per call, calls per call, name)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows, host = [], []
    # device-side events (kernels, copies, fills) for the device time:
    # the CPU ops that launched them carry the same time again
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            if ev.key.startswith("aten::"):
                host.append((ev.self_cpu_time_total / iters / 1e3,
                             ev.count // iters, ev.key))
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((us / iters / 1e3, ev.count // iters, ev.key))
    rows.sort(reverse=True)
    host.sort(reverse=True)
    return sum(r[0] for r in rows), rows[:5], host[:5]


def weight_label(params) -> str:
    """The weight mode of a parameter tree: bf16 (or float32), int8,
    fp8 or int4."""
    import torch
    from ome_tpu_torch.models.quant import QTensor
    wq = params["layers"]["wq"]
    if not isinstance(wq, QTensor):
        return "bf16" if wq.dtype == torch.bfloat16 else str(wq.dtype)[6:]
    if wq.bits == 4:
        return "int4"
    return "fp8" if wq.q.dtype == torch.float8_e4m3fn else "int8"


def kv_label(engine) -> str:
    weights = weight_label(engine.model.params)
    suffix = "" if weights in ("bf16", "float32") else f" {weights}"
    if not engine.kv_block:
        return "dense" + suffix
    return f"paged {'int8' if engine.kv_quantized else 'bf16'}{suffix}"


def _step_times(torch, engine, prompt, iters: int = 10,
                with_prefill: bool = True):
    """Wall time of one engine decode step (8 slots, all armed, lengths
    64-2164) and, `with_prefill`, of one cold 2048-token prefill, with
    the scheduler and server stopped, and the device time inside each
    from torch.profiler: 1 - device / wall is the share of the step the
    device sits idle waiting for the host."""
    import numpy as np
    dev = torch.device("cuda")
    state = engine.new_state()
    for slot in range(engine.max_slots):
        tok, kv, n, bucket = engine.prefill(prompt(64 + 300 * slot))
        state = engine.insert(state, kv, slot, n, tok, bucket)
    # device-resident sampling params, as the scheduler passes them
    greedy = (torch.zeros(engine.max_slots, device=dev),
              torch.zeros(engine.max_slots, dtype=torch.int32, device=dev),
              torch.ones(engine.max_slots, device=dev))
    box = [state]

    def decode():
        box[0], toks = engine.decode(box[0], *greedy)
        np.asarray(toks)

    long_prompt = prompt(2048)
    engine.prefix_cache.capacity_bytes = 0  # time cold prefills

    def prefill():
        engine.prefill(long_prompt)

    res = {}
    what = kv_label(engine)
    steps = (("decode", decode), ("prefill_2048", prefill)) \
        if with_prefill else (("decode", decode),)
    for name, fn in steps:
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(iters):
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        wall = statistics.median(times)
        busy, top, host = _device_profile(torch, fn, 3)
        res[name] = {"wall_ms": wall, "device_ms": busy or None,
                     "idle_share": 1 - busy / wall if busy else None,
                     "top": top, "host_top": host}
        if busy:
            log(f"[serve] {what} engine {name} step: wall {wall:.2f} ms, "
                f"device busy {busy:.2f} ms (torch.profiler), idle share "
                f"{1 - busy / wall:.2f}")
            for ms, count, key in top:
                log(f"[serve]   {ms:8.3f} ms  x{count:<4d} {key[:90]}")
            for ms, count, key in host:
                log(f"[serve]   host {ms:8.3f} ms self CPU  x{count:<4d} "
                    f"{key[:70]}")
        else:
            log(f"[serve] {what} engine {name} step: wall {wall:.2f} ms, "
                f"device time not measured (the profiler saw no device "
                f"activity)")
    return res


def phase_serve(torch, seed: int = 0, quantization: str = "none"):
    """The dense server at the Llama-3-8B shape, bf16 weights or
    `--quantization int4` (whose decode steps and prefills of up to 256
    tokens run B4, and whose longer prefills take the dequantizing
    route)."""
    import concurrent.futures
    import random
    import tempfile
    import urllib.request

    from ome_tpu_torch.engine import serve
    from ome_tpu_torch.models.config import llama3_8b
    from ome_tpu_torch.models.quant import quantized_bytes
    from ome_tpu_torch.ops import flash

    cfg = llama3_8b()
    rng = random.Random(seed)
    tag = "[serve]" if quantization == "none" else f"[serve {quantization}]"

    def prompt(n):
        return [rng.randrange(3, cfg.vocab_size) for _ in range(n)]

    out = {"quantization": quantization}
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "config.json"), "w") as f:
            json.dump(_hf_config(cfg), f)
        reqlog = os.path.join(tmp, "requests.jsonl")
        t0 = time.monotonic()
        server, sched, engine = serve.build_server(
            ["--model-dir", tmp, "--random-weights", "--seed", str(seed),
             "--max-slots", "8", "--max-seq", "4096", "--port", "0",
             "--host", "127.0.0.1", "--request-log", reqlog,
             "--quantization", quantization])
        torch.cuda.synchronize()
        out["startup_s"] = time.monotonic() - t0
        out["device_gib_after_startup"] = torch.cuda.memory_allocated() / 2**30
        out["weight_bytes"] = quantized_bytes(engine.model.params)
        log(f"{tag} Llama-3-8B shape, random "
            f"{weight_label(engine.model.params)} weights (seed {seed}), "
            f"{cfg.num_layers} layers, slots 8, max_seq 4096: server up "
            f"in {out['startup_s']:.1f} s; weights "
            f"{out['weight_bytes'] / 1e9:.3f} GB; device memory "
            f"{out['device_gib_after_startup']:.2f} GiB")
        url = f"http://127.0.0.1:{server.port}"
        # every Request the server builds, read back in process
        seen = []
        submit = sched.submit

        def recording_submit(req):
            seen.append(req)
            return submit(req)
        sched.submit = recording_submit
        try:
            flash.reset_launches()
            t_batch = time.monotonic()
            lengths = [16, 100, 400, 800, 1500, 2200, 2600, 3000]
            twin = prompt(24)
            bodies = [{"prompt": prompt(n), "max_tokens": 32,
                       "temperature": 0.0} for n in lengths]
            bodies += [{"prompt": list(twin), "max_tokens": 32,
                        "temperature": 0.0} for _ in range(2)]
            with concurrent.futures.ThreadPoolExecutor(len(bodies)) as ex:
                futs = [ex.submit(_post, url, b) for b in bodies]
                docs = [_completion(*f.result(), 32, f"request {i}")
                        for i, f in enumerate(futs)]
            out["batch_s"] = time.monotonic() - t_batch
            out["batch_completion_tokens"] = sum(
                d["usage"]["completion_tokens"] for d in docs)
            twins = [r for r in seen if r.prompt_ids == twin]
            if len(twins) != 2 or twins[0].output_ids != twins[1].output_ids:
                fail("serve: the twin prompts gave different outputs")
            log(f"{tag} {len(bodies)} concurrent completions (prompt "
                f"lengths {lengths} + 2 x 24-token twins): all 200, "
                f"{out['batch_completion_tokens']} tokens in "
                f"{out['batch_s']:.2f} s; twins identical")

            # prefix cache: the second prompt shares the first's
            # 1024-token prefix and is sent after the first finished
            shared = prompt(1024)
            hits0 = engine.prefix_cache.hits
            _completion(*_post(url, {"prompt": shared + prompt(200),
                                     "max_tokens": 32}), 32, "prefix 1")
            pre0 = flash.LAUNCHES["flash_prefill"]
            _completion(*_post(url, {"prompt": shared + prompt(150),
                                     "max_tokens": 32}), 32, "prefix 2")
            out["prefix_hits"] = engine.prefix_cache.hits - hits0
            if out["prefix_hits"] < 1:
                fail("serve: the shared-prefix request missed the "
                     "prefix cache")
            if flash.LAUNCHES["flash_prefill"] <= pre0:
                fail("serve: the prefix-suffix prefill launched no "
                     "flash_prefill kernel")
            log(f"{tag} shared 1024-token prefix: {out['prefix_hits']} "
                f"prefix-cache hit(s); suffix prefill went through "
                f"flash_prefill")

            status, raw = _post(url, {"prompt": prompt(64),
                                      "max_tokens": 32, "stream": True})
            events = [ln[6:] for ln in raw.decode().splitlines()
                      if ln.startswith("data: ")]
            if status != 200 or events[-1] != "[DONE]":
                fail("serve: the SSE stream did not end with [DONE]")
            final = json.loads(events[-2])
            n = final["usage"]["completion_tokens"]
            if not 1 <= n <= 32:
                fail(f"serve: stream gave {n} completion tokens")
            log(f"{tag} SSE stream: {n} tokens, ended with [DONE]")

            with urllib.request.urlopen(url + "/health", timeout=30) as r:
                health = json.loads(r.read())
            if health.get("status") != "ok":
                fail(f"serve: /health says {health}")
            torch.cuda.synchronize()
            launches = dict(flash.LAUNCHES)
        finally:
            server.stop()
        out["step"] = _step_times(torch, engine, prompt)
        with open(reqlog) as f:
            recs = [json.loads(line) for line in f]
    out["launches"] = launches
    needed = ["flash_decode", "flash_prefill"]
    if quantization == "int4":
        needed.append("int4_matmul")
    for name in needed:
        if launches[name] <= 0:
            fail(f"{tag}: kernel {name} was never launched while serving")
    ttft = sorted(r["ttft_s"] for r in recs if r.get("ttft_s") is not None)
    tpot = sorted(r["tpot_s"] for r in recs if r.get("tpot_s"))
    out["requests"] = [{k: r.get(k) for k in ("prompt_tokens",
                                             "output_tokens", "ttft_s",
                                             "tpot_s", "finish_reason")}
                       for r in recs]
    out["ttft_median_s"] = statistics.median(ttft)
    out["tpot_median_s"] = statistics.median(tpot)
    log(f"{tag} {len(recs)} requests: TTFT median "
        f"{out['ttft_median_s'] * 1e3:.1f} ms (max {ttft[-1] * 1e3:.1f}); "
        f"decode per request median {1 / out['tpot_median_s']:.1f} tok/s "
        f"(TPOT {out['tpot_median_s'] * 1e3:.2f} ms); concurrent phase "
        f"{out['batch_completion_tokens'] / out['batch_s']:.1f} tok/s")
    log(f"{tag} kernel launches while serving: {launches}")
    return out


def _free_device(torch, what: str) -> None:
    """Drop a finished phase's server, engine and weights from the card
    before the next 8B model is built."""
    import gc
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"[serve] after {what}: device memory allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")


def _wait_idle(sched, timeout: float = 120.0) -> None:
    t0 = time.monotonic()
    while not sched.drain_idle():
        if time.monotonic() - t0 > timeout:
            fail("serve: the scheduler did not go idle")
        time.sleep(0.01)


def _first_token_prompts(seed: int, vocab: int):
    """Prompts sent to both paged servers, alone, so their first tokens
    can be compared (prefill never reads the pool)."""
    import random
    rng = random.Random(seed + 1000)
    return [[rng.randrange(3, vocab) for _ in range(length)]
            for length in (40, 333, 777, 1500)]


def phase_serve_paged(torch, kv_dtype: str, seed: int = 0,
                      first_tokens=None):
    """The paged server at the Llama-3-8B shape: `--kv-block 128
    --max-slots 16 --max-seq 4096 --kv-blocks 129` (128 usable blocks,
    16384 rows: a quarter of the dense-equivalent 512 blocks), in bf16
    or int8. bf16: 16 concurrent completions whose prompts fill about
    3/4 of the pool plus two twins, then a burst larger than the pool
    (admission backpressure, preemption); int8: the first-token
    prompts, whose first tokens must equal the bf16 server's."""
    import concurrent.futures
    import random
    import tempfile

    from ome_tpu_torch.engine import serve
    from ome_tpu_torch.models.config import llama3_8b
    from ome_tpu_torch.ops import flash

    cfg = llama3_8b()
    rng = random.Random(seed + 1)

    def prompt(n):
        return [rng.randrange(3, cfg.vocab_size) for _ in range(n)]

    out = {"kv_dtype": kv_dtype}
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "config.json"), "w") as f:
            json.dump(_hf_config(cfg), f)
        t0 = time.monotonic()
        server, sched, engine = serve.build_server(
            ["--model-dir", tmp, "--random-weights", "--seed", str(seed),
             "--max-slots", "16", "--max-seq", "4096", "--kv-block", "128",
             "--kv-blocks", "129", "--kv-dtype", kv_dtype, "--port", "0",
             "--host", "127.0.0.1"])
        torch.cuda.synchronize()
        out["startup_s"] = time.monotonic() - t0
        out["device_gib_after_startup"] = torch.cuda.memory_allocated() / 2**30
        log(f"[paged {kv_dtype}] Llama-3-8B shape, seed {seed}, slots 16, "
            f"max_seq 4096, kv_block 128, kv_blocks 129 "
            f"({engine.kv_row_bytes()} bytes per cached token): server up "
            f"in {out['startup_s']:.1f} s; device memory "
            f"{out['device_gib_after_startup']:.1f} GiB")
        want = torch.int8 if kv_dtype == "int8" else torch.bfloat16
        if sched.state.k.dtype != want:
            fail(f"paged {kv_dtype}: the pool is {sched.state.k.dtype}")
        url = f"http://127.0.0.1:{server.port}"
        seen = []
        submit = sched.submit

        def recording_submit(req):
            seen.append(req)
            return submit(req)
        sched.submit = recording_submit

        def post_all(bodies, what):
            with concurrent.futures.ThreadPoolExecutor(len(bodies)) as ex:
                futs = [ex.submit(_post, url, b) for b in bodies]
                return [_completion(*f.result(), b["max_tokens"],
                                    f"{what} {i}")
                        for i, (f, b) in enumerate(zip(futs, bodies))]
        try:
            flash.reset_launches()
            firsts = []
            for ids in _first_token_prompts(seed, cfg.vocab_size):
                n0 = len(seen)
                _completion(*_post(url, {"prompt": ids, "max_tokens": 4,
                                         "temperature": 0.0}), 4,
                            "first-token prompt")
                firsts.append(seen[n0].output_ids[0])
            out["first_tokens"] = firsts
            if first_tokens is not None and firsts != first_tokens:
                fail(f"paged {kv_dtype}: first tokens {firsts} differ from "
                     f"the paged bf16 server's {first_tokens}")
            if kv_dtype == "bf16":
                lengths = [16, 40, 100, 180, 260, 350, 450, 560, 680, 800,
                           930, 1070, 1220, 1380, 1560, 2400]
                twin = prompt(24)
                bodies = [{"prompt": prompt(n), "max_tokens": 32,
                           "temperature": 0.0} for n in lengths]
                bodies += [{"prompt": list(twin), "max_tokens": 32,
                            "temperature": 0.0} for _ in range(2)]
                t_batch = time.monotonic()
                docs = post_all(bodies, "request")
                out["batch_s"] = time.monotonic() - t_batch
                out["batch_completion_tokens"] = sum(
                    d["usage"]["completion_tokens"] for d in docs)
                twins = [r for r in seen if r.prompt_ids == twin]
                if len(twins) != 2 or \
                        twins[0].output_ids != twins[1].output_ids:
                    fail("paged serve: the twin prompts gave different "
                         "outputs")
                log(f"[paged bf16] 16 concurrent completions (prompts "
                    f"{sum(lengths)} tokens, 3/4 of the pool's 16384 rows) "
                    f"+ 2 twins: all 200, "
                    f"{out['batch_completion_tokens']} tokens in "
                    f"{out['batch_s']:.2f} s; twins identical")
                # 2040-token prompts take 16 blocks each and need a 17th
                # at their 9th token: with the pool full of them, decode
                # growth has to preempt
                burst = [{"prompt": prompt(2040), "max_tokens": 32,
                          "temperature": 0.0} for _ in range(12)]
                t_burst = time.monotonic()
                post_all(burst, "burst request")
                out["burst_s"] = time.monotonic() - t_burst
                log(f"[paged bf16] burst of 12 x 2040-token prompts (24480 "
                    f"rows > the pool's 16384): all 200 in "
                    f"{out['burst_s']:.2f} s")
            _wait_idle(sched)
            torch.cuda.synchronize()
            launches = dict(flash.LAUNCHES)
            ok, owned = engine.kv_conservation()
            free = engine.kv_pool_stats["kv_blocks_free"]
            out.update(kv_conservation=ok, kv_blocks_free=free,
                       preemptions=sched.stats["preemptions_total"],
                       kv_requeues=sched.stats["kv_requeues_total"])
        finally:
            server.stop()
    out["launches"] = launches
    log(f"[paged {kv_dtype}] idle: kv_conservation {ok} (owned {owned}), "
        f"free blocks {free} of {engine.kv_blocks}; preemptions "
        f"{out['preemptions']}, requeues {out['kv_requeues']}; launches "
        f"{launches}")
    if not ok or free != engine.kv_blocks - 1:
        fail(f"paged {kv_dtype}: the pool is not conserved at idle "
             f"(ok {ok}, free {free} of {engine.kv_blocks})")
    for name in ("flash_paged_decode", "flash_prefill"):
        if launches[name] <= 0:
            fail(f"paged {kv_dtype}: kernel {name} was never launched "
                 "while serving")
    if launches["flash_decode"]:
        fail(f"paged {kv_dtype}: the dense decode kernel launched "
             f"{launches['flash_decode']} times during paged decode")
    return out


def phase_step_turns(torch, seed: int = 0, rounds: int = 2):
    """The decode step of the dense, paged bf16 and paged int8 engines
    over one set of Llama-3-8B weights (8 slots armed at lengths
    64-2164, max_seq 4096, kv_block 128), timed in turns (A B C C B A):
    the step is host-bound, so only times taken side by side in one run
    compare."""
    import random

    from ome_tpu_torch.engine.core import InferenceEngine
    from ome_tpu_torch.models.config import llama3_8b
    from ome_tpu_torch.models.params import init_params

    cfg = llama3_8b().replace(dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    params = init_params(cfg, gen, torch.device("cuda"))
    rng = random.Random(seed + 3)

    def prompt(n):
        return [rng.randrange(3, cfg.vocab_size) for _ in range(n)]
    kinds = {"dense": {}, "paged bf16": {"kv_block": 128},
             "paged int8": {"kv_block": 128, "kv_dtype": "int8"}}
    engines = {name: InferenceEngine(params, cfg, max_slots=8,
                                     max_seq=4096, device="cuda",
                                     seed=seed, **kw)
               for name, kw in kinds.items()}
    order = list(kinds) + list(kinds)[::-1]
    runs = {name: [] for name in kinds}
    for _ in range(rounds // 2):
        for name in order:
            runs[name].append(_step_times(torch, engines[name], prompt,
                                          with_prefill=False)["decode"])
    out = {}
    for name, rs in runs.items():
        out[name] = {"wall_ms": [r["wall_ms"] for r in rs],
                     "device_ms": [r["device_ms"] for r in rs],
                     "idle_share": [r["idle_share"] for r in rs],
                     "top": rs[-1]["top"], "host_top": rs[-1]["host_top"]}
        walls = ", ".join(f"{x:.2f}" for x in out[name]["wall_ms"])
        busy = ", ".join(f"{x:.2f}" for x in out[name]["device_ms"] if x)
        log(f"[steps] {name} decode step, runs in turns: wall {walls} ms; "
            f"device busy {busy} ms")
    del engines, params
    return out


def _greedy_streams(torch, eng, prompts, steps: int):
    """Greedy streams of `prompts` through the engine API: each prompt
    prefilled into slot 0, 1, ..., then `steps - 1` decode steps of
    every slot. Returns (streams, the top-2 logit gap of each slot at
    each decode step, the first decode step's fp32 logits of the
    prompts' slots)."""
    import numpy as np
    state = eng.new_state()
    out = []
    for slot, ids in enumerate(prompts):
        tok, kv, n, bucket = eng.prefill(ids)
        state = eng.insert(state, kv, slot, n, tok, bucket)
        out.append([int(tok)])
    top2, first = [], []
    sample = eng._sample

    def recording_sample(logits, *a):
        lf = logits.float().reshape(eng.max_slots, -1)
        top2.append(torch.topk(lf, 2).values)
        if not first:
            first.append(lf[:len(prompts)].clone())
        return sample(logits, *a)
    eng._sample = recording_sample
    n = eng.max_slots
    greedy = (np.zeros(n, np.float32), np.zeros(n, np.int32),
              np.ones(n, np.float32))
    try:
        for _ in range(steps - 1):
            state, toks = eng.decode(state, *greedy)
            for slot, t in enumerate(np.asarray(toks)[:len(prompts)]):
                out[slot].append(int(t))
    finally:
        del eng._sample
    gaps = [(t[:, 0] - t[:, 1]).cpu() for t in top2]
    return out, gaps, first[0]


def _drift(ref_streams, ref_gaps, streams):
    """Per prompt: the first step at which `streams` leaves the
    reference's, and the reference's top-2 logit gap at that step (None
    and None where the streams are identical)."""
    drift = []
    for slot, (a, b) in enumerate(zip(ref_streams, streams)):
        step = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                    None)
        gap = float(ref_gaps[step - 1][slot]) if step else None
        drift.append({"first_diff_step": step, "top2_gap": gap})
    return drift


def phase_quant_turns(torch, seed: int = 0, rounds: int = 2,
                      steps: int = 32):
    """Weight-only quantization at the Llama-3-8B shape, over one bf16
    weight set and the port's `quantize_params` of it:

    * the decode step of the bf16, int8, fp8 and int4 engines (dense
      cache, 8 slots armed at lengths 64-2164, max_seq 4096), timed in
      turns (A B C D D C B A) as phase_step_turns times the caches;
    * each quantized engine's drift from bf16 over `steps`-token greedy
      streams of 4 prompts (reported, not required to be zero);
    * B4 end to end: in a bf16 model B4's operands are exactly those of
      a bf16 `torch.mm` over the dequantized weight, so the int4
      engine's first decode-step logits are held against a twin engine
      whose int4 leaves are `dequant(bf16)` tensors. Each of the P = 7 x
      32 + 1 projections in sequence rounds its output to bf16 once,
      where B4 and the mm may land one ulp (2^-7 of the value) apart;
      the tolerance lets those steps add up as a random walk: 2^-7 x
      sqrt(P) of max |logits|."""
    import math
    import random

    from ome_tpu_torch.engine.core import InferenceEngine
    from ome_tpu_torch.models.config import llama3_8b
    from ome_tpu_torch.models.params import init_params
    from ome_tpu_torch.models.quant import (QTensor, quantize_params,
                                            quantized_bytes)
    from ome_tpu_torch.ops import flash

    cfg = llama3_8b().replace(dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    params = {"bf16": init_params(cfg, gen, torch.device("cuda"))}
    for mode in ("int8", "fp8", "int4"):
        t0 = time.monotonic()
        params[mode] = quantize_params(params["bf16"], mode=mode)
        torch.cuda.synchronize()
        log(f"[quant] quantize_params {mode} of the 8B bf16 weights on the "
            f"card: {time.monotonic() - t0:.1f} s")
    rng = random.Random(seed + 4)

    def prompt(n):
        return [rng.randrange(3, cfg.vocab_size) for _ in range(n)]
    engines = {name: InferenceEngine(p, cfg, max_slots=8, max_seq=4096,
                                     device="cuda", seed=seed)
               for name, p in params.items()}
    out = {name: {"weight_bytes": quantized_bytes(p)}
           for name, p in params.items()}
    out["device_gib_all_engines"] = torch.cuda.memory_allocated() / 2**30
    log(f"[quant] weight bytes: " + ", ".join(
        f"{name} {out[name]['weight_bytes'] / 1e9:.3f} GB"
        for name in engines) + f"; four engines built, device memory "
        f"{out['device_gib_all_engines']:.2f} GiB")
    order = list(engines) + list(engines)[::-1]
    runs = {name: [] for name in engines}
    for _ in range(rounds // 2):
        for name in order:
            runs[name].append(_step_times(torch, engines[name], prompt,
                                          with_prefill=False)["decode"])
    for name, rs in runs.items():
        out[name].update(wall_ms=[r["wall_ms"] for r in rs],
                         device_ms=[r["device_ms"] for r in rs],
                         idle_share=[r["idle_share"] for r in rs],
                         top=rs[-1]["top"], host_top=rs[-1]["host_top"])
        walls = ", ".join(f"{x:.2f}" for x in out[name]["wall_ms"])
        busy = ", ".join(f"{x:.2f}" for x in out[name]["device_ms"] if x)
        log(f"[quant] {name} weights, decode step, runs in turns: wall "
            f"{walls} ms; device busy {busy} ms")

    prompts = [prompt(n) for n in (37, 200, 515, 1000)]
    streams, gaps, first = {}, {}, {}
    for name, eng in engines.items():
        flash.reset_launches()
        streams[name], gaps[name], first[name] = _greedy_streams(
            torch, eng, prompts, steps)
        if name == "int4" and flash.LAUNCHES["int4_matmul"] <= 0:
            fail("quant: the int4 engine's streams launched no int4_matmul")
    for name in ("int8", "fp8", "int4"):
        out[name]["drift"] = _drift(streams["bf16"], gaps["bf16"],
                                    streams[name])
        log(f"[quant] {name} weights against bf16, {steps} greedy steps "
            f"per prompt (first differing step, bf16 top-2 logit gap "
            f"there; None = identical): "
            f"{[(d['first_diff_step'], d['top2_gap']) for d in out[name]['drift']]}")

    q4 = params["int4"]
    del engines, params
    twin_params = dict(q4, layers={
        k: v.dequant(torch.bfloat16) if isinstance(v, QTensor) and v.bits == 4
        else v for k, v in q4["layers"].items()})
    twin = InferenceEngine(twin_params, cfg, max_slots=8, max_seq=4096,
                           device="cuda", seed=seed)
    flash.reset_launches()
    twin_streams, _, twin_first = _greedy_streams(torch, twin, prompts, 2)
    if flash.LAUNCHES["int4_matmul"]:
        fail("quant: the twin engine launched int4_matmul")
    same = [i for i in range(len(prompts))
            if twin_streams[i][0] == streams["int4"][i][0]]
    if not same:
        fail("quant: every prefill token of the twin differs from the int4 "
             "engine's")
    ref, got = twin_first[same], first["int4"][same]
    err = (got - ref).abs().max().item()
    n_proj = 7 * cfg.num_layers + 1
    tol = 2 ** -7 * math.sqrt(n_proj) * ref.abs().max().item()
    argmax_same = int((got.argmax(-1) == ref.argmax(-1)).sum())
    out["twin"] = {"max_abs_err": err, "atol": tol,
                   "max_abs_logit": ref.abs().max().item(),
                   "slots_compared": len(same),
                   "argmax_equal": argmax_same}
    log(f"[quant] B4 end to end: int4 engine vs its dequant(bf16) twin, "
        f"first decode-step logits of {len(same)} prompts: max abs diff "
        f"{err:.4g} (tol {tol:.4g} = 2^-7 x sqrt({n_proj}) x max |logit| "
        f"{ref.abs().max().item():.4g}); argmax equal {argmax_same}/"
        f"{len(same)}")
    if not err <= tol:
        fail(f"quant: the int4 engine's logits differ from the twin's by "
             f"{err} (tol {tol})")
    del twin, twin_params, q4
    return out


def phase_stream_identity(torch, seed: int = 0, n_layers: int = 4,
                          steps: int = 32):
    """fp32 at the Llama-3-8B widths, `n_layers` deep: the dense engine
    (B1) and the paged engine with fp32 pools (B3) give identical
    greedy streams for 4 prompts, driven through the engine API. The
    paged engine with int8 pools runs the same prompts too: its drift
    from the fp32 pool (first differing step, the fp32 top-2 logit gap
    there) is reported, not required to be zero."""
    import random

    from ome_tpu_torch.engine.core import InferenceEngine
    from ome_tpu_torch.models.config import llama3_8b
    from ome_tpu_torch.models.params import init_params
    from ome_tpu_torch.ops import flash

    cfg = llama3_8b().replace(num_layers=n_layers, dtype=torch.float32)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    params = init_params(cfg, gen, torch.device("cuda"))
    rng = random.Random(seed + 2)
    prompts = [[rng.randrange(3, cfg.vocab_size) for _ in range(n)]
               for n in (37, 200, 515, 1000)]
    streams, gaps = {}, {}
    flash.reset_launches()
    for name, kw in (("dense", {}), ("paged", {"kv_block": 128}),
                     ("paged int8", {"kv_block": 128, "kv_dtype": "int8"})):
        eng = InferenceEngine(params, cfg, max_slots=4, max_seq=2048,
                              device="cuda", seed=seed, **kw)
        streams[name], gaps[name], _ = _greedy_streams(torch, eng, prompts,
                                                       steps)
        del eng
    launches = dict(flash.LAUNCHES)
    if launches["flash_decode"] <= 0 or launches["flash_paged_decode"] <= 0:
        fail(f"stream identity: a decode kernel did not run ({launches})")
    for slot in range(len(prompts)):
        a, b = streams["dense"][slot], streams["paged"][slot]
        if a != b:
            step = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
            gap = float(gaps["dense"][step - 1][slot]) if step else None
            fail(f"stream identity: prompt {slot} differs at step {step} "
                 f"(dense {a[step]}, paged {b[step]}; dense top-2 logit "
                 f"gap there {gap})")
    min_gap = min(float(g.min()) for g in gaps["dense"])
    log(f"[identity] fp32, Llama-3-8B widths, {n_layers} layers: dense "
        f"(flash_decode) and paged fp32 pool (flash_paged_decode) give "
        f"identical {steps}-token greedy streams for {len(prompts)} "
        f"prompts (smallest top-2 logit gap {min_gap:.3e})")
    int8_drift = _drift(streams["paged"], gaps["paged"],
                        streams["paged int8"])
    log(f"[identity] paged int8 pool against the paged fp32 pool, "
        f"{steps} greedy steps per prompt (first differing step, fp32 "
        f"top-2 logit gap there; None = identical): "
        f"{[(d['first_diff_step'], d['top2_gap']) for d in int8_drift]}")
    del params
    return {"streams_identical": True, "steps": steps,
            "prompts": len(prompts), "min_top2_gap": min_gap,
            "int8_drift": int8_drift, "launches": launches}


# -- main -----------------------------------------------------------------------


SOURCES = {
    "flash_decode": ("ome_tpu_torch/ops/csrc/flash_decode.cu",
                     "ome_tpu/ops/flash.py:148"),
    "flash_prefill": ("ome_tpu_torch/ops/csrc/flash_prefill.cu",
                      "ome_tpu/ops/flash.py:340"),
    "flash_paged_decode": ("ome_tpu_torch/ops/csrc/flash_paged_decode.cu",
                           "ome_tpu/ops/paged.py:155"),
    "flash_decode_quantized": (
        "ome_tpu_torch/ops/csrc/flash_paged_decode.cu",
        "ome_tpu/ops/flash.py:221"),
    "int4_matmul": ("ome_tpu_torch/ops/csrc/int4_matmul.cu",
                    "ome_tpu/ops/int4_matmul.py:126"),
}


def main() -> int:
    t0 = time.monotonic()
    import torch
    card = phase_device(torch)
    try:
        import ome_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the ome_tpu_torch package is not importable here ({e}); "
             "run from the root of the repository")
    report = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda}
    report["build_s"] = phase_build()
    report["kernel_cases"] = phase_kernels(torch)
    report["serve"] = phase_serve(torch)
    _free_device(torch, "the dense server")
    report["paged_bf16"] = phase_serve_paged(torch, "bf16")
    _free_device(torch, "the paged bf16 server")
    report["paged_int8"] = phase_serve_paged(
        torch, "int8", first_tokens=report["paged_bf16"]["first_tokens"])
    _free_device(torch, "the paged int8 server")
    report["serve_int4"] = phase_serve(torch, quantization="int4")
    _free_device(torch, "the int4 server")
    report["step_turns"] = phase_step_turns(torch)
    _free_device(torch, "the step-time engines")
    report["quant_turns"] = phase_quant_turns(torch)
    _free_device(torch, "the weight-quantization engines")
    report["stream_identity"] = phase_stream_identity(torch)
    report["total_s"] = time.monotonic() - t0
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    log(f"[done] {report['total_s']:.1f} s")
    # launches on each kernel's main path: the dense server for B1/B2,
    # the paged bf16 server for B3 and B5 (B5 is not wired into serving,
    # so that run counts 0 for it), the int4 server for B4
    launches = dict(report["serve"]["launches"])
    for name in ("flash_paged_decode", "flash_decode_quantized"):
        launches[name] = report["paged_bf16"]["launches"][name]
    launches["int4_matmul"] = report["serve_int4"]["launches"]["int4_matmul"]
    kernels = []
    for name, (source, replaces) in SOURCES.items():
        main_case = report["kernel_cases"][name][0]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": main_case["max_abs_err"],
            "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"],
            "library_ms": main_case["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
