"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives `ome_tpu_torch` only (never JAX, never `ome_tpu`):

1. device: the card's name and power limit, TF32 off, and
   `torch._grouped_mm` present (the MoE ragged dispatch needs it);
2. build: the hand-written CUDA kernels, compiled from `ome_tpu_torch/ops/
   csrc/` with nvcc for sm_90a (one nvcc per source, in parallel);
3. kernels: each kernel against its plain PyTorch version (fp32, same
   inputs) at the Llama-3-8B attention shapes, in bf16 and fp32, with the
   kernel's median time, the plain version's, the card's lower bound for
   the same work and, as a yardstick only, one
   `scaled_dot_product_attention` call. The prefill kernel (B2) runs
   causal buckets of 64 to 4096 tokens, a suffix chunk, window +
   softcap, G 1 and 8, head_dim 64, two sequences with their own bases
   and a ragged chunk whose cache tail past kv_hi is NaN, each with its
   share of the bound and, for the causal buckets, a second yardstick:
   SDPA with is_causal and no mask. The decode kernels run one decode
   core: B1 over the dense cache in bf16 and fp32, with window +
   softcap, at G 1, 4, 16 and D 64, and with NaN in every cache row
   outside the windows at S 4000 (a tile past S reads the next
   sequence's rows); B3 over a bf16, an fp32 and an int8 pool (random
   block table), with a free slot's all-trash table row, with NaN in
   every pool row (int8: scale) outside the windows, at the engine's 16
   slots of 32 blocks, with 32-row blocks and at G 16, D 64; B5 (int8
   dense) on B3's source; each with its share of the bound and its time
   with the split-KV kernels it replaced (`DECODE_MS_BEFORE`); the main
   cases of B1 and B3 (and the int8 pool) give the same bits on a
   second launch and for their longest sequence launched alone; the
   int4 weight-only matmul (B4) runs at
   the 8B projection shapes (w_gate, wq, wk at m 1, 5, 8, 16, 256; w_gate
   at m 17, 64, 128 and with fp32 output; w_down's K 14336 at m 8), each
   with its share of the bound and its time with the kernel it replaced,
   beside `_weight_int4pack_mm` and a bf16 `torch.mm` over the
   dequantized weight as yardsticks; the main case and wk at m 1 (the
   most K splits) must give the same bits on a second launch. B1, B2,
   B3 and B5 also run at group sizes G = H/K that are not powers of two
   (`GROUP_SHAPES`: G 3, 5, 6, 7 at D 128 and G 7 at D 64; B1 in bf16
   and fp32, B2 causal 2048 in bf16, and at G 7: B2 in fp32, a NaN-
   tailed chunk, a suffix chunk and the verify shape with its per-slot
   check; B3 over bf16 and int8 pools and B5 at every one of them, and
   at G 7 also over an fp32 pool, with bitwise repeats and with NaN
   outside the windows);
3a. head_dim 96 and 256 (`HEAD_DIM_SHAPES`: Phi-3-mini's H 32, K 32,
   D 96 and Gemma-2-9B's H 16, K 8, D 256): B1 in bf16 and fp32 and with
   window + softcap, B2 causal 2048 and window + softcap in bf16 and a
   suffix chunk in fp32, B3 over bf16, fp32 and int8 pools (at D 96
   also with Phi-3-mini's 64-row blocks and 2047-row window, lo > 0 and
   off the tile grid, NaN outside the windows), B5, each against its
   plain version; at D 96 B1 and B3 (bf16 and int8 pools) repeat their
   bits;
4. serve: the OpenAI HTTP server from `ome_tpu_torch.engine.serve.
   build_server` at the Llama-3-8B shape, all 32 layers (random bf16
   weights from a seed; phases 5-6 run at this depth too, the other
   8B-width servers at `CUT_LAYERS` = 8), answering concurrent
   completions, a stream, a prefix-cache hit and a repeated prompt, with the kernel launch counters read around it;
   then the engine's decode and prefill step times;
5. paged bf16: the same server with `--kv-block 128 --max-slots 16
   --kv-blocks 129` (a quarter of the dense-equivalent pool): concurrent
   completions filling 3/4 of the pool, twins, a burst larger than the
   pool (admission backpressure, preemption), the pool conserved at
   idle, B3 launched and B1 not;
6. paged int8: `--kv-dtype int8` with the same seed: first tokens equal
   the bf16 server's, B3's int8 branch launched, pool conserved;
7. serve int4: the dense server again, `CUT_LAYERS` deep, with
   `--quantization int4` (weights quantized at load): the same requests, B4 launched by its
   decode steps and short prefills, a prompt over 256 tokens through the
   dequantizing route; weight bytes, memory and step times;
8. step times: the dense, paged bf16 and paged int8 engines' decode
   steps over one set of weights (8B widths, `CUT_LAYERS` = 8 of its 32
   layers), timed in turns;
9. weight quantization: the bf16, int8, fp8 and int4 engines over one
   weight set (8B widths, `CUT_LAYERS` deep), decode steps timed in
   turns (the int4 step's device time
   printed beside its time with the int4 kernel this one replaced), each
   quantized engine's
   greedy drift from bf16, and the int4 engine's logits held against a
   twin whose int4 weights are dequantized to bf16 (B4 end to end);
10. stream identity: fp32 at the Llama-3-8B widths, 4 layers, through
   the engine API: dense decode (B1) and paged decode over fp32 pools
   (B3) give identical 32-token greedy streams; the int8 pool's drift
   from the fp32 pool over the same streams is reported;
11. checkpoint: a Llama-3-8B-width checkpoint (4 layers, bf16, HF names,
   two shards + index) written from the port's seeded init under
   chiprun_out/ (handed on to 11b), loaded back bit-equal (load GB/s),
   and served with `--model-dir` and no `--random-weights`: its first
   greedy tokens equal an engine's over the in-memory params;
11b. weight plane (`phase_weight_plane`): phase 11's tree parsed by
   `hfconfig` (family, exact parameter count), fetched from local://
   by the port's weight-plane CLI, SIGKILLed mid-fetch (the serving
   path absent) and resumed (every recorded object skipped), each
   published object's sha256 equal to the source's, fetch GB/s; the
   published tree served with one LoRA slot: /ready's fetch_bps equal
   to the manifest's, phase 11's greedy tokens through B1 and B2; the
   serving agent stages a rank-16 adapter zip from local:// and
   hot-loads it (tokens equal an in-process twin's), then removes it;
   the tree and the target are removed after;
12. step plans: fp32 at the 8B widths, 4 layers, dense and fp32 paged
   pool: single steps, `decode_multi` K=4 and the scheduler at
   spec_tokens 4 / steps_per_dispatch 4 give identical greedy streams
   for prompts that repeat n-grams, with drafts accepted; B1, B2 (at
   Sq 5, the dense verify) and B3 launched; the pool conserved;
13./14. step-plan servers: the bf16 8B server (`CUT_LAYERS` deep) with
   `--spec-tokens 4 --steps-per-dispatch 4`, dense then paged
   (`--kv-block 128`, a burst larger than the pool, conserved at idle):
   concurrent completions and a `json_schema` request whose output
   parses; spec proposed/accepted, chunks, launches and TPOT printed
   beside phases 4 and 5 for the record;
15./16. Qwen2.5-7B at full size (`QWEN25_7B`, 28 layers, G 7, q/k/v
   biases drawn non-zero), bf16: the dense server as phase 4 (B1, B2)
   and the paged bf16 server as phase 5 (B3, a burst larger than the
   pool, conserved at idle);
17. Qwen3-8B widths (`QWEN3_8B`, per-head q/k RMSNorm, scales drawn
   away from 1), 4 layers, fp32: dense and paged streams identical;
18. Mixtral-8x7B at full width (`MIXTRAL_8X7B`), 16 of its 32 layers
   in bf16 (~47 GB): the dense server as phase 4 through the ragged
   dispatch, then `torch._grouped_mm` against its plain version, a
   decode step under torch's sync debug mode (no host sync), the MoE
   block's device time per layer at decode and at a 2048-token prefill,
   and the experts (and expert bytes) a decode step of 8 slots hits;
19. Mixtral-8x7B widths, 4 layers, fp32: the ragged single-step,
   `decode_multi` K=4 and spec-4 / K-4 scheduler streams and the dense
   impl's are identical;
20. group sizes above 16 (`MQA_SHAPES`: G 24 = H 48 / K 2 and G 32 =
   H 32 / K 1, D 128): B1 in bf16 and fp32 at the 8B lengths, B2 causal
   2048 in bf16, B3 over bf16 and int8 pools and B5, each against its
   plain version, with two kernel launches per call (one per head chunk,
   `flash.head_split`) counted;
21. G 32 stream identity: fp32, 8B widths at H 32, K 1, 4 layers: dense
   and paged streams identical;
22. host tier: the 8B-width server `CUT_LAYERS` deep with
   `--prefix-cache-mb 64 --prefix-cache-host-mb 512` (`phase_host_tier`):
   spills, swap-ins, their GB/s and bits, TTFT by kind of hit, every
   prefix's device hit and swapped-in hit whole, their streams equal,
   both conservation checks at idle;
23. PD: 8B-width prefill and decode nodes (`CUT_LAYERS` deep) against a
   monolithic server
   (`phase_pd`), bf16 dense and int8 paged, with each fetch's split,
   failover across two prefill URLs and `--pd-local-fallback`; one bf16
   request through the port's router whose only backend is the decode
   node (`decoder=` pool) gives the node's direct stream;
24. cross-replica prefix reuse (`phase_peering`): an `X-OME-Prefix-Peer`
   fetch from a donor replica, streams equal, one peer fetch counted;
24a. the router (`phase_router`): the port's `RouterServer`
   (`cache_aware`) in front of two 8B-width replicas, `CUT_LAYERS` deep:
   three 1500-token prompts twice each, each pair on the replica the
   rendezvous hash names, the second a device prefix-cache hit equal to
   the replica's direct answer; a fourth prompt served by the other
   replica, learned on one health sweep and injected as
   X-OME-Prefix-Peer, one peer fetch, the owner's stream; 32 concurrent
   SSE streams through `AsyncRouterServer` with the threaded router's
   tokens; one replica stopped, its prompt served by the other with one
   retry; TTFT / TPOT medians through each router against direct;
25./26. Phi-3-mini-4k at full size (`PHI3_MINI_4K`: 32 layers, D 96,
   G 1, window 2047), bf16: the dense server as phase 4 (prompts of up
   to 3000 tokens, past the window: B1 and B2 at D 96 through their
   window paths) and the paged bf16 server as phase 5 with 64-row
   blocks (B3 at D 96, the window's first row as lo);
27. Phi-3-mini widths, 4 layers, fp32: dense and paged (64-row blocks)
   streams identical, prompts of up to 2500 tokens;
28. durable requests (`phase_journal`): a `--journal` server killed
   mid-decode (`engine_step.raise@N`, `--max-restarts 0`) and a fresh
   server resuming from the same directory: at 4 fp32 layers of
   Phi-3-mini widths the resumed stream is byte-identical to an
   uninterrupted server's; at full size in bf16 the first differing
   token is reported; journal bytes, appends and the replay time;
29. multi-LoRA identity (`phase_lora_identity`): fp32 at the Llama-3-8B
   widths, 4 layers, three seeded PEFT adapters (rank 16, alpha 32, all
   seven targets) in 4 slots: base and the three adapters in one decode
   batch, each stream identical to its request alone and each adapter's
   differing from the base's; each adapter against an engine over its
   `merge_lora` weights (first-step logits within LORA_MERGED_ATOL,
   identical streams); dense (B1) = paged (B3) streams under adapters;
   `decode_multi` K=4 and the spec-4 / K-4 scheduler (B2 at Sq 5) equal
   to single steps; unregister refused in flight, then re-registered by
   name;
30. multi-LoRA server (`phase_lora_server`): the bf16 Llama-3-8B server
   (`CUT_LAYERS` deep) with `--adapter a1=... a2=... a3=... --lora-slots 4
   --lora-rank 16`: 12 concurrent requests (4 base, 8 adapters), `POST
   /v1/adapters` a4 while decoding and a request to it, `DELETE
   /v1/adapters/a1` 409 while a1 decodes and 200 after; TTFT/TPOT
   medians mixed against the same prompts to the base model; decode
   step wall and device ms, idle share, launches and the delta's device
   ms with and without adapters in the batch; the stacks' bytes;
31. embeddings (`phase_embed`): e5-mistral-7b-instruct's widths,
   `CUT_LAYERS` deep, in bf16 through `serve --task embed` (`/v1/embeddings` for 8
   inputs, completions refused), then 48 inputs of 16-6000 tokens over
   the five buckets, one forward each (B2 at batch N per layer): batch,
   tokens/s, embeddings/s, device ms, idle share and B2 launches per
   bucket; unit norms; each input alone within cosine EMBED_COS_MIN of
   itself batched (bf16), and within EMBED_FP32_ATOL at 4 fp32 layers;
32. kernels at the later families' served shapes
   (`phase_family_kernels`): B1 and B2 at Gemma-2-9B's heads (H 16,
   K 8, D 256) with its scale and softcap 50, its 4096-row window and
   without, B1 over cache lengths
   64-8192 in bf16 and fp32, B2 causal 2048 and 8192 (bf16; fp32 at
   2048), B1 at command-r's G 1 (H = K = 64, D 128), and B1 and B2 at
   gpt-oss-20b's heads (H 64, K 8, D 64) with its sink logits and
   128-row window and without, each against its plain version, with its
   launches per call; and the sink attention through the kernels against
   `xla_attention` on the same card tensors;
33. fp32 identity on the card (`phase_family_identity`), 4 layers at
   the published widths of Gemma-2-9B, command-r v01, command-r7b (one
   period of P 4), Phi-3.5-MoE and gpt-oss-20b, biases, sinks and norm
   scales seeded: first-step logits (a 2000-token prefill, then one
   decode step) within 2e-4 of the same forward through the kernels'
   plain versions; single-step, `decode_multi` K=4 and spec-4 / K-4
   scheduler streams identical; B1 and B2 launched (gpt-oss's sinks in
   them) and no CUDA call of the plain attention;
34.-37. bf16 servers (`FAMILY_SERVERS`, through `phase_serve`), 13
   requests each: Gemma-2-9B, command-r7b, gpt-oss-20b and Phi-3.5-MoE
   at full width, `CUT_LAYERS` deep (prompts up to 6000 tokens,
   past the 4096-row window; Phi-3.5-MoE's longrope lists seeded, the
   long ones in use; peak device memory): TTFT / TPOT medians,
   decode-step device and wall ms, idle share, top kernels, B1 / B2
   launches per step; the MoE models' experts hit and the step's byte
   bound.

38. the MLA family (DeepSeek-V2-Lite, V3): fp32 identity
   (`phase_mla_identity`) at 4 layers of DeepSeek-V2-Lite's widths (1
   dense, 3 MoE) and of DeepSeek-V3's (3 dense, 1 MoE, its 256 routed
   experts cut to 32 in its 8 groups): the absorbed decode's logits
   within 1e-4 of the materialized forward's, single-step = chunk = spec
   streams (the verify runs the materialized path over the latent
   cache); a V2-Lite-width checkpoint under V3's architecture written
   with HF names (fused `kv_b_proj`, shared experts,
   `e_score_correction_bias`), loaded bit-equal and served
   (`phase_mla_checkpoint`); a bf16 PD pair at 4 layers whose streams
   equal the monolithic server's (`phase_mla_pd`); no attention kernel
   launched anywhere;
39. DeepSeek-V2-Lite at full size (27 layers, 15.7 B parameters) in
   bf16 (`phase_serve_mla`, `MLA_SERVERS`): 13 requests with prompts to
   6000 tokens at max_seq 8192 and a prefix-cache hit; TTFT / TPOT
   medians, the 8-slot decode step's device and wall ms, idle share and
   top kernels, peak memory, KV bytes per token against an MHA cache of
   the same heads; no B1, B2 or B3 launch;
40. DeepSeek-V3 at full width, 4 layers (3 dense, 1 MoE of 256 experts,
   q LoRA 1536, sigmoid_v3 with a seeded selection bias), served in
   bf16 and under `--quantization int4` with prompts to 2048 at max_seq
   4096: peak memory; the int4 server launches B4 at K 7168, N 2048 (the
   shared experts) and K 7168, N 18432 (the dense layers), counted per
   decode step; B4 at both shapes at m 8 against its plain version
   (`phase_mla_int4_kernel`), timed with L2 flushed beside its byte
   bound and `_weight_int4pack_mm`.
41. B1 and B2 at the per-rank shapes of tp 2 (`phase_tp_kernels`,
   `TP_SHAPES`: Llama-3-8B and Mixtral-8x7B halved, H 16 over K 4,
   D 128), and B4 at the 8B's per-rank int4 shapes (`TP_INT4_SHAPES`),
   against their plain versions;
42. tensor parallelism on one card (`phase_tp_identity`): two ranks on
   cuda:0 over gloo, this process the leader and a child process
   (`--tp-follower`) rank 1 replaying its op stream; fp32 at 4 layers of
   the Llama-3-8B, Mixtral-8x7B and DeepSeek-V2-Lite widths: first-step
   logits within 2e-4 of tp=1, single-step, `decode_multi` K=4 and
   spec-4 / K-4 scheduler streams equal to tp=1's, the follower's tokens
   equal to the leader's op for op at temperature 0.8 with top-k and
   top-p; the 8B widths again with int4 leaves: B4 launched on both
   ranks at the per-rank shapes, logits within 2e-4 and single-step
   streams equal to a tp=1 int4 engine's; and two NCCL ranks on one
   card refused (`NCCL_PROBE`);
43. `serve --tp 2 --device cuda:0` at Llama-3-8B full size, bf16
   (`phase_serve_tp`): three of phase 4's concurrent prompts (16, 800
   and 3000 tokens) to 16 tokens, then its shared-prefix pair and SSE
   stream at 8 tokens, TTFT / TPOT medians, the streams against phase
   4's, B1 and B2 launched on both ranks, each
   rank's decode-step device and wall ms and collectives' share over an
   8-slot window (rank 1's by `--rank-stats`), peak memory per rank;
44. the LWS environment (`phase_tp_lws`): two `serve` processes under
   JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID with
   `--control-port` and `--tp-backend gloo`, 4 fp32 layers of the 8B widths: completions equal
   the tp=1 server's; the follower killed, the leader's /health 503.
45. training (`phase_train`): B2's backward (bf16: the wgmma kernel of
   `csrc/flash_prefill_bwd_wgmma.cu` on the lse plane B2's forward
   writes, held against the plain lse within `BWD_LSE_ATOL`; fp32: the
   scalar `csrc/flash_prefill_bwd.cu`) against its plain version's
   gradient (`BWD_CASES`: the 8B's heads at causal 2048 and the training
   step's B 2 in bf16 and fp32, G 7, D 96 at G 1, Gemma-2-9B's D 256
   with softcap 50, a window and logits that reach the cap, G 32,
   gpt-oss-20b's heads with its window and sinks, whose gradient is
   checked too; dq, dk and dv within `BWD_REL_TOL` of each gradient's
   rms, the fp32 case against the plain version in fp64; the same bits
   on a second launch; planted faults written into a plain backward,
   `BWD_FAULTS`, each beyond the same tolerance; bf16 also through
   `FlashPrefill` under `torch.autograd.grad`, which must give the
   wrapper's bits, and B2's output under `lse=` against the plain
   output), with its median ms, each launch's device ms (CUDA events the
   C side records), ptxas's registers and spills, bound, share,
   plain ms and, where it computes the same function, the backward of a
   causal SDPA call as a yardstick; whether
   `torch._grouped_mm` has a backward here; `make_train_step` at the
   8B's widths, `CUT_LAYERS` deep, bf16: 5 steps of 4 x 2048 tokens in
   2 microbatches on a constant target, the loss falling every step,
   the step's wall and device ms, tokens/s, model-FLOPs share, peak
   memory and B2's forward and backward launches; the loss and
   gradients of one step of 2 layers at the 8B widths, fp32 (the scalar
   backward) and bf16 (the wgmma one), through the kernels against the
   same through their plain versions (loss within `TRAIN_ID_LOSS_RTOL`,
   each leaf's gradient within `TRAIN_ID_GRAD_RTOL` of its rms; the same
   through a B2 whose backward swaps dk and dv must fall outside it);
   and a save / restore / resume of a narrow model whose
   next loss equals the uninterrupted run's bit for bit.
46. the fleet under faults and load (`phase_fleet`), through the port's
   harness (`ome_tpu_torch/chaos.py`, `autoscale/`) with port engine
   children on the card: the Llama-3-8B widths at 4 fp32 layers, random
   weights from seed 0, 32-row paged blocks. Two chaos episodes (seeds
   scanned from `_plan_episode`): one unified engine behind the asyncio
   router with an engine_step fault and a SIGKILL mid-decode, and a PD
   pair with a pd_insert fault and the prefill peer killed mid-handoff,
   each over a bursty trace of two tenants (batch, every third request
   interactive) on 3-block pools (the engines preempt and recompute);
   every invariant of the harness holds and every greedy
   stream a child's journal finished equals the oracle's by token ids;
   B2 and B3 dispatched in the children (their program ledgers). The
   closed loop (`run_closed_loop`, 1-2 replicas, the reference smoke's
   bursty trace): 1 -> 2 -> 1 replicas, no request failed, no journal
   entry left live. Two models (those widths and Qwen2.5-7B's, 4 layers)
   under a weight budget that holds one: `ensure` on the second drains
   and evicts the first; the first's child profiled while it serves (B2
   and B3 in its own trace) and given two tenants (four batch requests
   fill its two slots, two interactive ones arrive: a batch request is
   preempted for them, its flight event read from /debug/events, and
   every request finishes); the card's free memory back within 1 GiB.
   Printed beside the card's name and power limit: each child's
   spawn-to-/health seconds, respawn-to-resume and journal drain
   seconds, the replicas over time, the scale-up's decision-to-
   registered seconds, client e2e and the engines' TTFT/TPOT p50/p99,
   each engine's memory.

The kernels phase also runs B2 at the dense verify's shape: B 8 slots,
Sq 5 rows each from its own base (60 to 4090) over a 4096-row cache,
bf16 and fp32. Each phase's seconds are printed (`[phase]`).

Prints one `{"kernels": [...]}` line, then the card's name and power limit,
then `{"ok": true, "device": {...}}` as the last line. Any failed phase
exits non-zero without that line. Longer per-case results go to
`chiprun_out/chip_smoke.json`.
"""

from __future__ import annotations

import collections
import contextlib
import json
import math
import os
import pathlib
import re
import signal
import statistics
import subprocess
import sys
import threading
import time

# the card's memory rate and dense bf16 peak: the H100 row of the port's
# device table (ome_tpu_torch/perf/ledger.py, which the online roofline
# reads too), set by phase_device
HBM_BYTES_PER_S = None
# the depth of the phases cut to keep the whole script inside its time
# budget: the weight turns (8, 9), the host tier (22) and PD (23) first,
# then the step-plan servers (13, 14), peering (24), the LoRA server (30)
# and phase 31's 8B step; since the tp phases (41-44), also the
# embeddings (31), the later families' servers (34-37) and the int4
# server (7). The main bf16 servers (4-6), whose launches feed the
# kernels line, keep the 8B's 32 layers, and DeepSeek-V2-Lite (39) its
# 27.
CUT_LAYERS = 8
# device time of one cold 2048-token bf16 prefill of the 8B engine with
# the mma.sync prefill kernel that the wgmma kernel replaced (NVIDIA
# H100 80GB HBM3, 700 W), printed beside this run's
PREFILL_2048_DEVICE_MS_BEFORE = 66.75
# device time of one int4-weight decode step (8 armed slots, weight
# turns) with the int4 kernel that the TMA/persistent one replaced
# (NVIDIA H100 80GB HBM3, 700 W), printed beside this run's
INT4_STEP_DEVICE_MS_BEFORE = 34.8
PEAK_FLOPS = {"bf16": None,        # dense tensor-core bf16 (phase_device)
              "fp32": 67e12}       # fp32 outside the tensor cores
ATOL = {"bf16": 2e-2, "fp32": 2e-4}
# cache lengths of the 8 slots of the B2 verify cases (Sq = 5 from each)
VERIFY_BASES = (60, 611, 1187, 1702, 2333, 2901, 3517, 4090)
# the verify cases' outputs are small (rms ~0.03 in a window of 4095
# rows), so each slot's max |kernel - plain| is also held against that
# slot's rms of the plain output
VERIFY_REL_TOL = {"bf16": 5e-2, "fp32": 1e-4}
# The published configurations the later phases run, typed in from each
# model's public config.json (nothing is downloaded; weights are random
# from a seed). "_source" names the file; from_hf_config ignores it.
LLAMA32_3B = {"_source": "meta-llama/Llama-3.2-3B config.json",
              "architectures": ["LlamaForCausalLM"], "vocab_size": 128256,
              "hidden_size": 3072, "num_hidden_layers": 28,
              "num_attention_heads": 24, "num_key_value_heads": 8,
              "head_dim": 128, "intermediate_size": 8192,
              "rope_theta": 500000.0, "rms_norm_eps": 1e-5,
              "max_position_embeddings": 131072,
              "tie_word_embeddings": True,
              "rope_scaling": {"rope_type": "llama3", "factor": 32.0,
                               "low_freq_factor": 1.0,
                               "high_freq_factor": 4.0,
                               "original_max_position_embeddings": 8192}}
QWEN25_7B = {"_source": "Qwen/Qwen2.5-7B config.json",
             "architectures": ["Qwen2ForCausalLM"], "model_type": "qwen2",
             "vocab_size": 152064, "hidden_size": 3584,
             "num_hidden_layers": 28, "num_attention_heads": 28,
             "num_key_value_heads": 4, "intermediate_size": 18944,
             "rope_theta": 1000000.0, "rms_norm_eps": 1e-6,
             "max_position_embeddings": 131072,
             "use_sliding_window": False, "sliding_window": 131072,
             "max_window_layers": 28, "tie_word_embeddings": False}
QWEN3_8B = {"_source": "Qwen/Qwen3-8B config.json",
            "architectures": ["Qwen3ForCausalLM"], "model_type": "qwen3",
            "vocab_size": 151936, "hidden_size": 4096,
            "num_hidden_layers": 36, "num_attention_heads": 32,
            "num_key_value_heads": 8, "head_dim": 128,
            "intermediate_size": 12288, "rope_theta": 1000000.0,
            "rms_norm_eps": 1e-6, "max_position_embeddings": 40960,
            "attention_bias": False, "use_sliding_window": False,
            "sliding_window": None, "tie_word_embeddings": False}
MIXTRAL_8X7B = {"_source": "mistralai/Mixtral-8x7B-v0.1 config.json",
                "architectures": ["MixtralForCausalLM"],
                "model_type": "mixtral", "vocab_size": 32000,
                "hidden_size": 4096, "num_hidden_layers": 32,
                "num_attention_heads": 32, "num_key_value_heads": 8,
                "intermediate_size": 14336, "num_local_experts": 8,
                "num_experts_per_tok": 2, "rope_theta": 1000000.0,
                "rms_norm_eps": 1e-5, "max_position_embeddings": 32768,
                "sliding_window": None, "tie_word_embeddings": False}
# Mixtral-8x7B in bf16 is ~93 GB at 32 layers; the card has 80 GB, so
# the served model keeps 16 of its layers (~47 GB), at full width
MIXTRAL_SERVED_LAYERS = 16
PHI3_MINI_4K = {"_source": "microsoft/Phi-3-mini-4k-instruct config.json",
                "architectures": ["Phi3ForCausalLM"], "model_type": "phi3",
                "vocab_size": 32064, "hidden_size": 3072,
                "num_hidden_layers": 32, "num_attention_heads": 32,
                "num_key_value_heads": 32, "intermediate_size": 8192,
                "rope_theta": 10000.0, "rope_scaling": None,
                "rms_norm_eps": 1e-5, "max_position_embeddings": 4096,
                "original_max_position_embeddings": 4096,
                "sliding_window": 2047, "hidden_act": "silu",
                "attention_bias": False, "tie_word_embeddings": False}
# Gemma-2-9B's attention shape (16 query heads over 8 KV heads of 256;
# google/gemma-2-9b config.json): the kernel cases at head_dim 256
GEMMA2_9B_HEADS = (16, 8, 256)
# Gemma 2, command-r, Cohere2, Phi-3.5-MoE and gpt-oss. Gemma 2 and
# Cohere2 leave tie_word_embeddings out of their files (the class
# default, True, ties them: the checkpoints carry no lm_head), so it is
# written here.
GEMMA2_9B = {"_source": "google/gemma-2-9b config.json",
             "architectures": ["Gemma2ForCausalLM"], "model_type": "gemma2",
             "vocab_size": 256000, "hidden_size": 3584,
             "intermediate_size": 14336, "num_hidden_layers": 42,
             "num_attention_heads": 16, "num_key_value_heads": 8,
             "head_dim": 256, "query_pre_attn_scalar": 256,
             "attn_logit_softcapping": 50.0,
             "final_logit_softcapping": 30.0, "sliding_window": 4096,
             "rms_norm_eps": 1e-6, "rope_theta": 10000.0,
             "max_position_embeddings": 8192,
             "hidden_activation": "gelu_pytorch_tanh",
             "attention_bias": False, "tie_word_embeddings": True}
COMMAND_R_V01 = {"_source": "CohereForAI/c4ai-command-r-v01 config.json",
                 "architectures": ["CohereForCausalLM"],
                 "model_type": "cohere", "vocab_size": 256000,
                 "hidden_size": 8192, "intermediate_size": 22528,
                 "num_hidden_layers": 40, "num_attention_heads": 64,
                 "num_key_value_heads": 64, "layer_norm_eps": 1e-5,
                 "logit_scale": 0.0625, "max_position_embeddings": 8192,
                 "rope_theta": 8000000.0, "use_qk_norm": False,
                 "attention_bias": False, "tie_word_embeddings": True}
COMMAND_R7B = {"_source": "CohereForAI/c4ai-command-r7b-12-2024 "
                          "config.json",
               "architectures": ["Cohere2ForCausalLM"],
               "model_type": "cohere2", "vocab_size": 256000,
               "hidden_size": 4096, "intermediate_size": 14336,
               "num_hidden_layers": 32, "num_attention_heads": 32,
               "num_key_value_heads": 8, "head_dim": 128,
               "layer_norm_eps": 1e-5, "logit_scale": 0.25,
               "max_position_embeddings": 8192, "rope_theta": 50000,
               "rope_scaling": None, "sliding_window": 4096,
               "sliding_window_pattern": 4, "attention_bias": False,
               "tie_word_embeddings": True}


def _seeded_factors(seed: int, n: int, top: float):
    """A monotone list of n RoPE extension factors from 1 up to about
    `top`, drawn from `seed`: Phi-3.5-MoE's published short/long lists
    are not in the repository, so its configuration carries seeded
    lists of the published length (head_dim / 2 = 64) instead."""
    import random
    rng = random.Random(seed)
    return sorted(1.0 + (top - 1.0) * rng.random() for _ in range(n))


PHI35_MOE = {"_source": "microsoft/Phi-3.5-MoE-instruct config.json "
                        "(longrope factor lists seeded)",
             "architectures": ["PhiMoEForCausalLM"], "model_type": "phimoe",
             "vocab_size": 32064, "hidden_size": 4096,
             "intermediate_size": 6400, "num_hidden_layers": 32,
             "num_attention_heads": 32, "num_key_value_heads": 8,
             "num_local_experts": 16, "num_experts_per_tok": 2,
             "attention_bias": True, "lm_head_bias": True,
             "rms_norm_eps": 1e-5, "router_jitter_noise": 0.01,
             "input_jitter_noise": 0.01, "max_position_embeddings": 131072,
             "original_max_position_embeddings": 4096,
             "rope_theta": 10000.0, "sliding_window": 131072,
             "tie_word_embeddings": False,
             "rope_scaling": {"type": "longrope",
                              "original_max_position_embeddings": 4096,
                              "short_factor": _seeded_factors(35, 64, 1.3),
                              "long_factor": _seeded_factors(36, 64, 40.0),
                              "short_mscale": 1.243163121016122,
                              "long_mscale": 1.243163121016122}}
GPT_OSS_20B = {"_source": "openai/gpt-oss-20b config.json",
               "architectures": ["GptOssForCausalLM"], "model_type": "gpt_oss",
               "vocab_size": 201088, "hidden_size": 2880,
               "intermediate_size": 2880, "num_hidden_layers": 24,
               "num_attention_heads": 64, "num_key_value_heads": 8,
               "head_dim": 64, "num_local_experts": 32,
               "num_experts_per_tok": 4, "experts_per_token": 4,
               "attention_bias": True, "rms_norm_eps": 1e-5,
               "sliding_window": 128, "max_position_embeddings": 131072,
               "initial_context_length": 4096, "rope_theta": 150000,
               "rope_scaling": {"rope_type": "yarn", "factor": 32.0,
                                "beta_fast": 32.0, "beta_slow": 1.0,
                                "original_max_position_embeddings": 4096,
                                "truncate": False},
               "swiglu_limit": 7.0, "tie_word_embeddings": False}


def _heads(hf):
    return (hf["num_attention_heads"], hf["num_key_value_heads"],
            hf.get("head_dim") or hf["hidden_size"]
            // hf["num_attention_heads"])


# (H, K, D) of the kernel cases at group sizes G = H/K that are not
# powers of two: G 3 (Llama-3.2-3B), G 5 (Qwen2.5-14B and -32B: 40 / 8),
# G 6 (Qwen2.5-1.5B: 12 / 2), G 7 (Qwen2.5-7B) and G 7 at D 64
# (Qwen2.5-0.5B: 14 / 2)
GROUP_SHAPES = (_heads(LLAMA32_3B), (40, 8, 128), (12, 2, 128),
                _heads(QWEN25_7B), (14, 2, 64))
# (H, K, D) of the kernel cases at the head_dims past 64 and 128:
# Phi-3-mini (D 96, G 1) and Gemma-2-9B (D 256, G 2)
HEAD_DIM_SHAPES = (_heads(PHI3_MINI_4K), GEMMA2_9B_HEADS)
# beside the script, whatever the working directory (a child process
# of this script writes where its parent reads)
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "chiprun_out")


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


# -- phase 1: device ----------------------------------------------------------


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
    if not hasattr(torch, "_grouped_mm"):
        fail(f"torch {torch.__version__} has no torch._grouped_mm: the "
             "MoE ragged dispatch (models/llama.py::_grouped) needs it")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        from ome_tpu_torch.perf.ledger import device_spec
    except ImportError as e:
        fail(f"the ome_tpu_torch package is not importable here ({e}); "
             "run from the root of the repository")
    global HBM_BYTES_PER_S
    spec = device_spec(torch.device("cuda"))
    HBM_BYTES_PER_S = spec["hbm_gbps"] * 1e9
    PEAK_FLOPS["bf16"] = spec["peak_tflops"] * 1e12
    log(f"[device] nvidia-smi: {card}")
    log(f"[device] roofline row of the port's device table: "
        f"{spec['hbm_gbps']} GB/s, {spec['peak_tflops']} bf16 TFLOP/s "
        f"(kind {spec['kind']!r})")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    log(f"[device] matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    return card


# -- phase 2: build -----------------------------------------------------------


def phase_build():
    """Build the kernels; log ptxas's registers and spills, each under
    the `Function properties for` line that names its kernel, and any
    compiler warning."""
    from ome_tpu_torch.ops import _build
    secs = _build.build()
    log(f"[build] nvcc sm_90a build of {sorted(_build.SOURCES)}: "
        f"{secs:.1f} s")
    for name, text in sorted(_build.build_logs.items()):
        for line in text.splitlines():
            if any(w in line for w in ("Function properties for",
                                       "registers", "spill", "warning")):
                log(f"[build] {name}: {line.strip()}")
    return secs


# -- phase 3: kernels against their plain versions ----------------------------


def _inputs(torch, gen, B, Sq, S, H, K, D, dtype, device):
    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=device,
                           dtype=torch.float32).to(dtype)
    return randn(B, Sq, H, D), randn(B, S, K, D), randn(B, S, K, D)


def _sdpa(torch, q, k, v, mask, is_causal=False):
    """One scaled_dot_product_attention call computing the same
    function (yardstick only; the port never calls it)."""
    F = torch.nn.functional
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

    def fn():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              is_causal=is_causal,
                                              enable_gqa=True)
    try:
        fn()
    except TypeError:  # torch without enable_gqa: no yardstick
        return None
    return fn


def _check_bits(torch, label, out, again, alone, part):
    """The bitwise checks of a decode case: `again` (a second launch on
    the same inputs) and `alone` (one sequence launched by itself) must
    equal `out` and `out[part]`."""
    same = bool(torch.equal(out, again))
    inv = bool(torch.equal(out[part], alone))
    if not same:
        fail(f"{label}: two launches on the same inputs gave different "
             f"bits")
    if not inv:
        fail(f"{label}: a sequence launched alone gave other bits than "
             f"inside the batch")
    return same, inv


def _nan_outside(torch, x, lo, hi, rows_of):
    """x with NaN in every row that no window [lo[b], hi[b]) reads;
    rows_of(b, r) gives the row of x that holds sequence b's row r."""
    keep = torch.zeros(x.shape[0] * x.shape[1], dtype=torch.bool,
                       device=x.device)
    for b, (a, z) in enumerate(zip(lo.tolist(), hi.tolist())):
        r = torch.arange(max(a, 0), max(z, 0), device=x.device)
        if r.numel():
            keep[rows_of(b, r)] = True
    flat = x.reshape(-1, *x.shape[2:]).clone()
    flat[~keep] = float("nan")
    return flat.reshape(x.shape)


def decode_case(torch, timer, gen, dtype_name, lengths, window=None,
                softcap=None, B=8, S=4096, H=32, K=8, D=128,
                nan_outside=False, check_bits=False, sinks=False):
    """B1 at one shape against flash_decode_ref (fp32, same inputs).
    `sinks`: per-head sink logits (gpt-oss; seeded, std 2) in the
    kernel and the plain version alike; SDPA takes none, so no library
    time.
    `nan_outside`: every cache row outside the windows is NaN (the
    rows before lo under a window, past hi, and so the next sequence's
    first rows that a tile running past S takes in); those rows are not
    part of the function, so the plain version reads them as 0.
    `check_bits`: a second launch gives the same bits, and the sequence
    with the longest window launched alone gives the same bits as in
    the batch."""
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
    # (passed only with sinks, so that the cases also run an earlier
    # package's wrappers, as `kernels_ab` does)
    sk = (_sink_logits(torch, gen, H),) if sinks else ()
    kr, vr = k, v
    if nan_outside:
        k = _nan_outside(torch, k.reshape(B * S, 1, K, D), lo, hi,
                         lambda b, r: b * S + r).reshape(B, S, K, D)
        v = _nan_outside(torch, v.reshape(B * S, 1, K, D), lo, hi,
                         lambda b, r: b * S + r).reshape(B, S, K, D)
    out = flash.flash_decode(q, k, v, lo, hi, scale, softcap, *sk)
    ref = flash.flash_decode_ref(q.float(), kr.float(), vr.float(), lo, hi,
                                 scale, softcap, *sk)
    torch.cuda.synchronize()
    label = (f"decode {dtype_name} B={B} S={S} H={H} K={K} D={D} "
             f"lengths={lengths} window={window} softcap={softcap}"
             + (" nan_outside" if nan_outside else "")
             + (" sinks" if sinks else ""))
    if not torch.isfinite(out.float()).all():
        fail(f"flash_decode {label}: non-finite output")
    err = (out.float() - ref).abs().max().item()
    same = inv = None
    if check_bits:
        b = int((hi - lo).argmax())
        sl = slice(b, b + 1)
        same, inv = _check_bits(
            torch, f"flash_decode {label}", out,
            flash.flash_decode(q, k, v, lo, hi, scale, softcap, *sk),
            flash.flash_decode(q[sl], k[sl], v[sl], lo[sl], hi[sl], scale,
                               softcap, *sk), sl)
    ms = timer.ms(lambda: flash.flash_decode(q, k, v, lo, hi, scale,
                                             softcap, *sk))
    plain_ms = timer.ms(lambda: flash.flash_decode_ref(
        q.float(), k.float(), v.float(), lo, hi, scale, softcap, *sk),
        iters=5)
    lib_ms = None
    if not softcap and not nan_outside and not sinks:
        col = torch.arange(S, device=dev)
        mask = ((col[None, :] >= lo[:, None]) & (col[None, :] < hi[:, None])
                )[:, None, None, :]
        fn = _sdpa(torch, q, k, v, mask)
        if fn is not None:
            lib_ms = timer.ms(fn)
    rows = int((hi - lo).clamp(min=0).sum())
    esize = q.element_size()
    nbytes = (2 * rows * K * D * esize + 2 * q.numel() * esize + 2 * B * 4
              + (4 * H if sinks else 0))
    bound = _bound(nbytes, 4 * D * H * rows, dtype_name)
    return {"case": label, "max_abs_err": err, "atol": ATOL[dtype_name],
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "same_bits": same, "batch_invariant": inv,
            "ms_before": DECODE_MS_BEFORE.get(label),
            "share_of_bound": bound["bound_ms"] / ms, **bound}


# the plain prefill's fp32 logits [B, H, Sq, S] of one call at most;
# past it, `_prefill_plain` runs it in blocks of query rows
PLAIN_LOGITS_BYTES = 4 << 30


def _sink_logits(torch, gen, H):
    """[H] fp32 sink logits on the card (seeded, std 2: some above the
    rows' logits, some below)."""
    return torch.randn(H, generator=gen, device="cuda",
                       dtype=torch.float32) * 2.0


def _prefill_plain(torch, q, k, v, base, kv_hi, scale, softcap, window,
                   *sinks):
    """flash_prefill_ref on fp32 copies of the inputs, in blocks of query
    rows where one call's fp32 logits would pass PLAIN_LOGITS_BYTES:
    query row i's output depends only on its own position base + i, so
    the blocks give the values of the one call."""
    from ome_tpu_torch.ops import flash
    B, Sq, H, _ = q.shape
    S = k.shape[1]
    step = max(1, PLAIN_LOGITS_BYTES // (B * H * S * 4))
    kf, vf = k.float(), v.float()
    return torch.cat([flash.flash_prefill_ref(
        q[:, i:i + step].float(), kf, vf, base + i, kv_hi, scale, softcap,
        window, *sinks) for i in range(0, Sq, step)], dim=1)


def prefill_case(torch, timer, gen, dtype_name, Sq, S, base, window=None,
                 softcap=None, B=1, H=32, K=8, D=128, bases=None,
                 kv_hi=None, nan_tail=False, rel_tol=None, sinks=False):
    """B2 at one shape against flash_prefill_ref (fp32, same inputs; in
    blocks of query rows past PLAIN_LOGITS_BYTES, `_prefill_plain`).
    `sinks`: per-head sink logits as in `decode_case` (no library time).
    `bases` gives each sequence its own base (default `base` for all);
    kv_hi defaults to base + Sq. With `rel_tol`, each sequence's max
    |kernel - plain| over the rms of its plain output must stay within
    it too (`rel_errs`, one per sequence). `nan_tail` fills every K/V row at or
    past kv_hi with NaN: those rows are outside the function, so the
    output must stay finite (the plain version runs on the clean
    copy). Yardsticks: `library_ms`, one masked SDPA call; for causal
    cases with base 0 and Sq == S == kv_hi, `library_causal_ms`, SDPA
    with is_causal and no mask (free to take its flash backend)."""
    from ome_tpu_torch.ops import flash
    dev = torch.device("cuda")
    dtype = torch.bfloat16 if dtype_name == "bf16" else torch.float32
    q, k, v = _inputs(torch, gen, B, Sq, S, H, K, D, dtype, dev)
    bases = list(bases) if bases is not None else [base] * B
    his = [min(b0 + Sq if kv_hi is None else kv_hi, S) for b0 in bases]
    base_t = torch.tensor(bases, dtype=torch.int32, device=dev)
    kv_hi_t = torch.tensor(his, dtype=torch.int32, device=dev)
    scale = D ** -0.5
    sk = (_sink_logits(torch, gen, H),) if sinks else ()  # as decode_case
    ref = _prefill_plain(torch, q, k, v, base_t, kv_hi_t, scale, softcap,
                         window, *sk)
    clean = (k, v)
    if nan_tail:
        k, v = k.clone(), v.clone()
        for i, hi in enumerate(his):
            k[i, hi:] = float("nan")
            v[i, hi:] = float("nan")

    def kernel():
        return flash.flash_prefill(q, k, v, base_t, kv_hi_t, scale, softcap,
                                   window, *sk)
    out = kernel()
    torch.cuda.synchronize()
    if not torch.isfinite(out.float()).all():
        fail(f"flash_prefill {dtype_name} Sq={Sq} S={S}: non-finite output")
    err = (out.float() - ref).abs().max().item()
    rel = {}
    if rel_tol is not None:
        per_seq = (out.float() - ref).abs().flatten(1).amax(1)
        rms = ref.flatten(1).pow(2).mean(1).sqrt()
        rel = {"rel_errs": (per_seq / rms).tolist(), "rel_tol": rel_tol}
    ms = timer.ms(kernel)
    plain_ms = timer.ms(lambda: _prefill_plain(
        torch, q, clean[0], clean[1], base_t, kv_hi_t, scale, softcap,
        window, *sk), iters=3)
    lib_ms = lib_causal_ms = None
    # (no yardstick past the plain version's cap: SDPA with a mask and
    # GQA takes its math backend, which holds all the logits at once)
    if not (softcap or sinks) and B * H * Sq * S * 4 <= PLAIN_LOGITS_BYTES:
        col = torch.arange(S, device=dev)[None, None, :]
        pos = (base_t[:, None] + torch.arange(Sq, device=dev)[None, :]
               )[:, :, None]
        mask = (col <= pos) & (col < kv_hi_t[:, None, None])
        if window:
            mask = mask & (col > pos - window)
        fn = _sdpa(torch, q, clean[0], clean[1], mask[:, None])
        if fn is not None:
            lib_ms = timer.ms(fn)
        if not window and Sq == S and set(bases) == {0} and \
                set(his) == {S}:
            fn = _sdpa(torch, q, clean[0], clean[1], None, is_causal=True)
            if fn is not None:
                lib_causal_ms = timer.ms(fn)
    pairs = rows = 0
    for b0, hi in zip(bases, his):
        pos = b0 + torch.arange(Sq)
        top = torch.clamp(pos + 1, max=hi)
        lo = (pos - window + 1).clamp(min=0) if window else \
            torch.zeros_like(pos)
        pairs += int((top - lo).clamp(min=0).sum())
        rows += max(hi - (max(b0 - window + 1, 0) if window else 0), 0)
    esize = q.element_size()
    nbytes = (2 * q.numel() + 2 * rows * K * D) * esize
    nbytes += 4 * H if sinks else 0
    return {"case": f"prefill {dtype_name} B={B} Sq={Sq} S={S} "
                    f"base={bases if B > 1 else bases[0]} kv_hi="
                    f"{his if B > 1 else his[0]} H={H} K={K} D={D} "
                    f"window={window} softcap={softcap}"
                    + (" nan_tail" if nan_tail else "")
                    + (" sinks" if sinks else ""),
            "max_abs_err": err, "atol": ATOL[dtype_name],
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "library_causal_ms": lib_causal_ms, **rel,
            **_bound(nbytes, 4 * D * H * pairs, dtype_name)}


def phase_prefill_kernel(torch, timer, gen):
    """B2 at the Llama-3-8B attention shape (H 32, K 8, D 128, B 1)
    unless a case says otherwise; the main case, first, is the causal
    2048-token prompt. Causal buckets 64 to 4096, a suffix chunk into a
    filled cache, window + softcap, G 1 and 8, D 64, two sequences with
    their own bases, a ragged chunk whose cache tail past kv_hi is NaN,
    the fp32 kernel's two cases, the verify shape, and the group sizes
    that do not divide 64 (`GROUP_SHAPES`; at G 7 also fp32, a NaN
    tail, a suffix chunk and the verify shape), and the embeddings
    path's smallest and largest buckets (B 10 at 32, B 8 at 8192, window
    4096; bf16 and fp32)."""
    cases = [prefill_case(torch, timer, gen, "bf16", 2048, 2048, 0)]
    for n in (64, 256, 4096):
        cases.append(prefill_case(torch, timer, gen, "bf16", n, n, 0))
    cases += [
        prefill_case(torch, timer, gen, "bf16", 512, 2048, 1024),
        prefill_case(torch, timer, gen, "bf16", 2048, 2048, 0, window=512,
                     softcap=50.0),
        prefill_case(torch, timer, gen, "bf16", 2048, 2048, 0, K=32),
        prefill_case(torch, timer, gen, "bf16", 2048, 2048, 0, K=4),
        prefill_case(torch, timer, gen, "bf16", 2048, 2048, 0, D=64),
        prefill_case(torch, timer, gen, "bf16", 1024, 2048, 0, B=2,
                     bases=(0, 300)),
        prefill_case(torch, timer, gen, "bf16", 1000, 1024, 0,
                     nan_tail=True),
        prefill_case(torch, timer, gen, "fp32", 2048, 2048, 0),
        prefill_case(torch, timer, gen, "fp32", 512, 2048, 1024),
    ]
    # the dense speculative verify: k+1 = 5 query rows per slot, each
    # slot from its own base (its cache length) over a 4096-row cache
    for dt in ("bf16", "fp32"):
        cases.append(prefill_case(torch, timer, gen, dt, 5, 4096, 0, B=8,
                                  bases=VERIFY_BASES,
                                  rel_tol=VERIFY_REL_TOL[dt]))
    # group sizes that do not divide 64 (floor(64 / G) positions per
    # warpgroup, the rest of its rows idle): causal 2048 in bf16, G 7 in
    # fp32, a ragged NaN-tailed chunk and the verify shape at G 7
    for H, K, D in GROUP_SHAPES:
        cases.append(prefill_case(torch, timer, gen, "bf16", 2048, 2048, 0,
                                  H=H, K=K, D=D))
    cases += [
        prefill_case(torch, timer, gen, "fp32", 512, 2048, 1024, H=28, K=4),
        prefill_case(torch, timer, gen, "bf16", 1000, 1024, 0, H=28, K=4,
                     nan_tail=True),
        prefill_case(torch, timer, gen, "bf16", 512, 2048, 1024, H=28,
                     K=4),
    ]
    for dt in ("bf16", "fp32"):
        cases.append(prefill_case(torch, timer, gen, dt, 5, 4096, 0, B=8,
                                  bases=VERIFY_BASES, H=28, K=4,
                                  rel_tol=VERIFY_REL_TOL[dt]))
    # the embeddings path (phase 31): one launch per layer at batch N,
    # base 0, Sq = S = kv_hi = the bucket, with Mistral's window 4096 at
    # every bucket (in effect only past 4096). The right padding of a
    # row is ordinary rows to the kernel, after the row's last real
    # token. The 32 bucket at batch 10 and the 8192 bucket at batch 8
    for dt in ("bf16", "fp32"):
        cases += [prefill_case(torch, timer, gen, dt, 32, 32, 0, B=10,
                               window=EMBED_WINDOW),
                  prefill_case(torch, timer, gen, dt, 8192, 8192, 0, B=8,
                               window=EMBED_WINDOW)]
    for c in cases:
        lc = c["library_causal_ms"]
        log(f"[kernels] flash_prefill {c['case']}: share of bound "
            f"{c['bound_ms'] / c['ms']:.3f}; library_causal_ms "
            f"{'null' if lc is None else f'{lc:.4f}'}")
    return {"flash_prefill": cases}


def _bound(nbytes, flops, dtype_name):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


def paged_case(torch, timer, gen, pool_name, lengths, trash_slot=None,
               B=8, H=32, K=8, D=128, bs=128, M=32, N=257,
               nan_outside=False, check_bits=False, window=None):
    """B3 over a pool of N blocks with a random permutation table (no
    two sequences share a block; block 0 stays the trash block). A
    `trash_slot` gets an all-zero table row, as a free engine slot has,
    and a length past M * bs: its output must be finite. `window`: the
    served sliding window W, which the wrapper passes on as each
    sequence's first row lo = length - W. `nan_outside`: every pool row
    outside the windows is NaN (int8: its scales), the blocks outside
    every table row and the rows of a sequence's blocks outside
    [lo, length); the plain version reads them as 0. `check_bits`: a
    second launch gives the same bits, and the sequence with the longest
    window launched alone gives the same bits as in the batch."""
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
    hi = kv_len.clamp(max=M * bs)
    lo = paged._window_lo(kv_len, window).clamp(max=M * bs)
    kr, vr, ksr, vsr = kp, vp, ks, vs
    if nan_outside:
        def rows_of(b, r):  # pool row of sequence b's row r
            return table[b, r // bs].long() * bs + r % bs
        if ks is None:
            kp = _nan_outside(torch, kp, lo, hi, rows_of)
            vp = _nan_outside(torch, vp, lo, hi, rows_of)
        else:  # int8 values are finite: the scales carry the NaN
            def scales(x):
                t = x.transpose(1, 2).contiguous()       # [N, bs, K]
                t = _nan_outside(torch, t, lo, hi, rows_of)
                return t.transpose(1, 2).contiguous()
            ks, vs = scales(ks), scales(vs)

    def kernel():
        return paged.paged_flash_decode(q, kp, vp, table, kv_len, scale,
                                        k_scale=ks, v_scale=vs,
                                        sliding_window=window)

    def plain(kk, vv, sk, sv):
        return paged.flash_paged_decode_ref(
            q.float(), kk if sk is not None else kk.float(),
            vv if sv is not None else vv.float(), table, lo, kv_len,
            scale, k_scale=sk, v_scale=sv)
    out, ref = kernel(), plain(kr, vr, ksr, vsr)
    torch.cuda.synchronize()
    label = (f"paged {pool_name} B={B} H={H} K={K} D={D} bs={bs} M={M} "
             f"N={N} lengths={lengths} trash_slot={trash_slot}"
             + (f" window={window}" if window else "")
             + (" nan_outside" if nan_outside else ""))
    if not torch.isfinite(out.float()).all():
        fail(f"flash_paged_decode {label}: non-finite output")
    err = (out.float() - ref).abs().max().item()
    same = inv = None
    if check_bits:
        b = int((hi - lo).argmax())
        sl = slice(b, b + 1)
        same, inv = _check_bits(
            torch, f"flash_paged_decode {label}", out, kernel(),
            paged.paged_flash_decode(q[sl], kp, vp, table[sl], kv_len[sl],
                                     scale, k_scale=ks, v_scale=vs,
                                     sliding_window=window), sl)
    ms = timer.ms(kernel)
    plain_ms = timer.ms(lambda: plain(kp, vp, ks, vs), iters=5)
    rows = int((hi - lo).sum())
    esize = kp.element_size()
    nbytes = (2 * rows * K * D * esize + 2 * q.numel() * q.element_size()
              + B * M * 4 + B * 4)
    if ks is not None:
        nbytes += 2 * rows * K * 4
    dt = "fp32" if pool_name == "fp32" else "bf16"
    bound = _bound(nbytes, 4 * D * H * rows, dt)
    return {"case": label, "max_abs_err": err, "atol": ATOL[dt], "ms": ms,
            "plain_ms": plain_ms, "library_ms": None,
            "same_bits": same, "batch_invariant": inv,
            "ms_before": DECODE_MS_BEFORE.get(label),
            "share_of_bound": bound["bound_ms"] / ms, **bound}


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
    label = (f"int8 dense B={B} S={S} H={H} K={K} D={D} "
             f"lengths={lengths} window={window} softcap={softcap}")
    bound = _bound(nbytes, 4 * D * H * rows, "bf16")
    return {"case": label, "max_abs_err": err, "atol": ATOL["bf16"],
            "ms": ms, "plain_ms": plain_ms, "library_ms": None,
            "ms_before": DECODE_MS_BEFORE.get(label),
            "share_of_bound": bound["bound_ms"] / ms, **bound}


def phase_paged_kernels(torch, timer, gen):
    """B3 in its three pool dtypes, with a trash-table slot, with NaN in
    every pool row outside the windows (bf16 and int8), at the engine's
    shape (16 slots of 32 blocks), with 32-row blocks (two TMA boxes per
    tile) and at G 16, D 64; and B5; then B3 over bf16 and int8 pools
    and B5 at each of `GROUP_SHAPES`, and at G 7 (H 28, K 4) also over
    the fp32 pool and with NaN outside the windows; each against its
    plain version. The main case, first, the int8 pool and the G 7 bf16
    and int8 pools repeat their bits and give a sequence the same bits
    alone as in the batch."""
    lengths = [1, 17, 128, 300, 1023, 2049, 4095, 4096]
    cases = {"flash_paged_decode": [], "flash_decode_quantized": []}
    add = cases["flash_paged_decode"].append
    for pool_name in ("bf16", "fp32", "int8"):
        add(paged_case(torch, timer, gen, pool_name, lengths,
                       check_bits=pool_name != "fp32"))
    add(paged_case(torch, timer, gen, "bf16", lengths[:7] + [5000],
                   trash_slot=7))
    for pool_name in ("bf16", "int8"):
        add(paged_case(torch, timer, gen, pool_name, lengths,
                       nan_outside=True))
    add(paged_case(torch, timer, gen, "bf16",
                   [1, 5, 64, 100, 257, 512, 700, 1000, 1500, 2048, 2500,
                    3000, 3500, 4000, 4095, 4096], B=16, N=513))
    add(paged_case(torch, timer, gen, "bf16", lengths, bs=32, M=128,
                   N=1025))
    add(paged_case(torch, timer, gen, "bf16", lengths, K=2, D=64, bs=64,
                   M=64, N=513))
    cases["flash_decode_quantized"].append(quantized_case(
        torch, timer, gen, [0, 1, 17, 128, 300, 1023, 2049, 4095]))
    # group sizes that are not powers of two: B3 over bf16 and int8
    # pools and B5 at each of `GROUP_SHAPES`; at G 7 (Qwen2.5-7B: H 28,
    # K 4) also the fp32 pool, NaN outside the windows and bitwise repeats
    for H, K, D in GROUP_SHAPES:
        for pool_name in ("bf16", "int8"):
            add(paged_case(torch, timer, gen, pool_name, lengths, H=H, K=K,
                           D=D, check_bits=(H, K, D) == (28, 4, 128)))
        cases["flash_decode_quantized"].append(quantized_case(
            torch, timer, gen, [0, 1, 17, 128, 300, 1023, 2049, 4095], H=H,
            K=K, D=D))
    add(paged_case(torch, timer, gen, "fp32", lengths, H=28, K=4))
    for pool_name in ("bf16", "int8"):
        add(paged_case(torch, timer, gen, pool_name, lengths, H=28, K=4,
                       nan_outside=True))
    for name, rows in cases.items():
        _log_decode_cases(name, rows)
    return cases


def _log_decode_cases(name, rows):
    for c in rows:
        before = ("not measured" if c.get("ms_before") is None
                  else f"{c['ms_before']:.4f} ms")
        bits = ("" if c.get("same_bits") is None else
                f"; two launches bitwise equal {c['same_bits']}; alone "
                f"= in batch {c['batch_invariant']}")
        log(f"[kernels] {name} {c['case']}: share of bound "
            f"{c['share_of_bound']:.3f}; the split-KV kernels {before}{bits}")


def phase_decode_kernels(torch, timer, gen):
    """B1 at the Llama-3-8B decode shape (B 8, S 4096, H 32, K 8, D 128)
    in bf16 and fp32, with window + softcap, with NaN in every cache row
    outside the windows at S 4000 (a tile past S reads the next
    sequence's rows) with and without a window, at G 1 and 16 and D 64,
    and at the `GROUP_SHAPES` in bf16 and fp32 (G 7 also with NaN
    outside the windows). The main case, first, and G 7 in bf16 repeat
    their bits and give a sequence the same bits alone as in the
    batch."""
    lengths = [0, 1, 17, 128, 300, 1023, 2049, 4095]
    cases = [decode_case(torch, timer, gen, "bf16", lengths,
                         check_bits=True),
             decode_case(torch, timer, gen, "fp32", lengths),
             decode_case(torch, timer, gen, "bf16", lengths, window=256,
                         softcap=30.0),
             decode_case(torch, timer, gen, "bf16",
                         [4000, 3999, 4000, 1000, 4000, 700, 300, 4000],
                         window=256, S=4000, nan_outside=True),
             decode_case(torch, timer, gen, "bf16",
                         [1, 17, 63, 64, 300, 3999, 4000, 2049], S=4000,
                         nan_outside=True),
             decode_case(torch, timer, gen, "bf16", lengths, K=32),
             decode_case(torch, timer, gen, "bf16", lengths, K=2),
             decode_case(torch, timer, gen, "bf16", lengths, D=64)]
    # group sizes that are not powers of two (padded to 8 or 16 query
    # rows on the tensor cores, G warps on the CUDA cores)
    for H, K, D in GROUP_SHAPES:
        cases.append(decode_case(torch, timer, gen, "bf16", lengths, H=H,
                                 K=K, D=D, check_bits=(H, K) == (28, 4)))
        cases.append(decode_case(torch, timer, gen, "fp32", lengths, H=H,
                                 K=K, D=D))
    cases.append(decode_case(torch, timer, gen, "bf16",
                             [1, 17, 63, 64, 300, 3999, 4000, 2049], S=4000,
                             H=28, K=4, nan_outside=True))
    _log_decode_cases("flash_decode", cases)
    return {"flash_decode": cases}


# Scratch variants of the split-KV decode kernels (`flash_decode.cu`,
# `flash_paged_decode.cu`, two launches per call), for
# `decode_decompose`: each is (file, old text, new text), applied once.
_DECOMPOSE_EDITS = {
    "loads only": [  # the tile's math skipped, its copies kept
        ("flash_decode.cu", "    const int row = r0 + t * TR + lane;",
         "    if (ntiles < 0) {\n    const int row = r0 + t * TR + lane;"),
        ("flash_paged_decode.cu",
         "    const int row = alo + (first + t) * kTile + lane;",
         "    if (ntiles < 0) {\n"
         "    const int row = alo + (first + t) * kTile + lane;"),
        ("*", "    __syncthreads();  // tile t consumed",
         "    }\n    __syncthreads();  // tile t consumed")],
    "math only": [  # no copies: the math runs on whatever smem holds
        ("*", "      cp_async16(&Ks[buf]", "      if (0) cp_async16(&Ks[buf]"),
        ("*", "      cp_async16(&Vs[buf]", "      if (0) cp_async16(&Vs[buf]"),
        ("flash_paged_decode.cu", "        cp_async16(&Ss[buf]",
         "        if (0) cp_async16(&Ss[buf]")],
    "empty pass 1": [
        ("flash_decode.cu", "  constexpr int TR = 32;",
         "  if (n_split > 0) return;\n  constexpr int TR = 32;"),
        ("flash_paged_decode.cu", "  constexpr bool QUANT =",
         "  if (n_split > 0) return;\n  constexpr bool QUANT =")],
    "merge pass alone": [
        ("flash_decode.cu", "  decode_partial<T, D, G><<<",
         "  if (0) decode_partial<T, D, G><<<"),
        ("flash_paged_decode.cu", "  paged_partial<TQ, TKV, D, G>\n",
         "  if (0) paged_partial<TQ, TKV, D, G>\n")],
    "pass 1 alone": [
        ("*", "  split_kv_combine<", "  if (0) split_kv_combine<")],
}


def decode_decompose(torch, csrc, iters: int = 30):
    """Time the split-KV B1 and B3 kernels that the decode core replaced
    (the sources under `csrc`, e.g. from a `git archive` of an earlier
    commit's `ome_tpu_torch/ops/csrc`) at their main cases, as built
    and in the scratch variants of `_DECOMPOSE_EDITS`, each built with
    the port's nvcc flags; plus the Timer's reading around one tiny
    elementwise kernel. Returns
    {kernel: {variant: ms}}. Run alone:

        python3 -c "import chip_smoke as c, torch; c.phase_device(torch);
            c.decode_decompose(torch, 'DIR/ome_tpu_torch/ops/csrc')"
    """
    import ctypes
    import shutil

    from ome_tpu_torch.ops import _build, flash
    dev = torch.device("cuda")
    timer = Timer(torch, dev)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    root = os.path.join(OUT_DIR, "decompose")
    shutil.rmtree(root, ignore_errors=True)
    procs = {}
    for variant in ["as built"] + list(_DECOMPOSE_EDITS):
        vdir = os.path.join(root, variant.replace(" ", "_"))
        shutil.copytree(csrc, vdir)
        for fname, old, new in _DECOMPOSE_EDITS.get(variant, []):
            for f in (("flash_decode.cu", "flash_paged_decode.cu")
                      if fname == "*" else (fname,)):
                path = os.path.join(vdir, f)
                text = open(path).read()
                if text.count(old) != 1:
                    fail(f"decompose {variant}: {old!r} not once in {f}")
                open(path, "w").write(text.replace(old, new))
        for src in ("flash_decode", "flash_paged_decode"):
            out = os.path.join(vdir, f"{src}.so")
            procs[(variant, src)] = (out, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-o", out,
                 os.path.join(vdir, f"{src}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for key, (out, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            fail(f"decompose {key}: nvcc failed:\n{err}")
        libs[key] = ctypes.CDLL(out)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

    B, S, H, K, D = 8, 4096, 32, 8, 128
    q, k, v = _inputs(torch, gen, B, 1, S, H, K, D, torch.bfloat16, dev)
    lens = torch.tensor([0, 1, 17, 128, 300, 1023, 2049, 4095],
                        dtype=torch.int32, device=dev)
    lo, hi = torch.zeros_like(lens), lens.clone()
    bs, M, N = 128, 32, 257
    kp = torch.randn(N, bs, K, D, generator=gen, device=dev).to(
        torch.bfloat16)
    vp = torch.randn(N, bs, K, D, generator=gen, device=dev).to(
        torch.bfloat16)
    kq, ks = flash.quantize_kv_block(kp)
    vq, vs = flash.quantize_kv_block(vp)
    table = (torch.randperm(N - 1, generator=gen, device=dev)[:B * M] + 1
             ).reshape(B, M).to(torch.int32)
    plens = torch.tensor([1, 17, 128, 300, 1023, 2049, 4095, 4096],
                         dtype=torch.int32, device=dev)
    plo = torch.zeros_like(plens)
    n_split = 16  # their decode_splits(4096)
    pm = torch.empty(B * H * n_split, dtype=torch.float32, device=dev)
    pl = torch.empty_like(pm)
    pa = torch.empty(B * H * n_split * D, dtype=torch.float32, device=dev)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(dev).cuda_stream
    scale = D ** -0.5
    results = {"B1 bf16": {}, "B3 bf16": {}, "B3 int8": {}}
    for (variant, src), lib in sorted(libs.items()):
        if src == "flash_decode":
            fn = lib.ome_flash_decode
            fn.argtypes = [P] * 9 + [I] * 6 + [F, F, I, P]
            args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), lo.data_ptr(),
                    hi.data_ptr(), out.data_ptr(), pm.data_ptr(),
                    pl.data_ptr(), pa.data_ptr(), B, S, H, K, D, n_split,
                    scale, 0.0, 1, stream)
            runs = {"B1 bf16": args}
        else:
            fn = lib.ome_flash_paged_decode
            fn.argtypes = [P] * 12 + [I] * 7 + [F, F, I, I, P]
            runs = {}
            for name, kk, vv, sk, sv in (("B3 bf16", kp, vp, None, None),
                                         ("B3 int8", kq, vq, ks, vs)):
                runs[name] = (
                    q.data_ptr(), kk.data_ptr(), vv.data_ptr(),
                    sk.data_ptr() if sk is not None else None,
                    sv.data_ptr() if sv is not None else None,
                    table.data_ptr(), plo.data_ptr(), plens.data_ptr(),
                    out.data_ptr(), pm.data_ptr(), pl.data_ptr(),
                    pa.data_ptr(), B, bs, M, H, K, D, n_split, scale, 0.0,
                    1, int(sk is not None), stream)
        fn.restype = I
        for name, args in runs.items():
            if fn(*args) != 0:
                fail(f"decompose {variant} {name}: launch failed")
            torch.cuda.synchronize()
            results[name][variant] = timer.ms(lambda: fn(*args), iters)
    tiny = torch.zeros(256, device=dev)
    results["timer floor (one tiny elementwise kernel)"] = timer.ms(
        lambda: tiny.add_(1.0), iters)
    for name, row in results.items():
        log(f"[decompose] {name}: {row}")
    return results


# Scratch variants of the decode core (`decode_core.cuh`), for
# `core_variants`: each is (old text, new text), applied once.
_CORE_EDITS = {
    "no math (consumers release each stage on arrival)": [
        ("      mbar_wait(&full[s], (gi / stages) & 1);\n",
         "      mbar_wait(&full[s], (gi / stages) & 1);\n"
         "      if (g.limit >= 0) { __syncwarp(); if (lane == 0) "
         "mbar_arrive(&empty[s]); continue; }\n")],
    "no loads (the producer completes each stage without copies)": [
        ("          mbar_arrive_expect_tx(&full[s], L::kTx);\n",
         "          mbar_arrive(&full[s]); if (g.limit >= 0) continue;\n")],
    "no merge (nor its handshake)": [
        ("    if (last_split(cnt, un.b * g.K + un.kh,",
         "    if (g.limit < 0 && last_split(cnt, un.b * g.K + un.kh,")],
    "no tiles (units' own work only)": [
        ("        for (int r0 = un.r0; r0 < un.r1;",
         "        for (int r0 = un.r0; r0 < un.r0;"),
        ("    for (int r0 = un.r0; r0 < un.r1;",
         "    for (int r0 = un.r0; r0 < un.r0;")],
}


def _decode_main_cases(torch, gen):
    """Callables of the decode core's main cases: B1 bf16, B3 over the
    bf16 and the int8 pool, B5 (chip_smoke's first case of each), and
    B1 and B3 over the windows of the serving phases' decode steps."""
    from ome_tpu_torch.ops import flash, paged
    dev = torch.device("cuda")
    B, S, H, K, D = 8, 4096, 32, 8, 128
    q, k, v = _inputs(torch, gen, B, 1, S, H, K, D, torch.bfloat16, dev)
    lens = torch.tensor([0, 1, 17, 128, 300, 1023, 2049, 4095],
                        dtype=torch.int32, device=dev)
    lo = torch.zeros_like(lens)
    bs, M, N = 128, 32, 257
    kp = torch.randn(N, bs, K, D, generator=gen, device=dev).to(
        torch.bfloat16)
    vp = torch.randn(N, bs, K, D, generator=gen, device=dev).to(
        torch.bfloat16)
    kq, ks = flash.quantize_kv_block(kp)
    vq, vs = flash.quantize_kv_block(vp)
    table = (torch.randperm(N - 1, generator=gen, device=dev)[:B * M] + 1
             ).reshape(B, M).to(torch.int32)
    plens = torch.tensor([1, 17, 128, 300, 1023, 2049, 4095, 4096],
                         dtype=torch.int32, device=dev)
    dq, dks = flash.quantize_kv_block(k)
    dvq, dvs = flash.quantize_kv_block(v)
    pos = (lens - 1).clamp(min=0)[:, None]
    scale = D ** -0.5
    # the windows of the serving phases' decode steps (8 slots armed at
    # lengths 64 + 300 slot, plus the step's own token)
    slens = torch.tensor([65 + 300 * i for i in range(B)],
                         dtype=torch.int32, device=dev)
    return {
        "B1 bf16": lambda: flash.flash_decode(q, k, v, lo, lens, scale),
        "B1 bf16 serving windows": lambda: flash.flash_decode(
            q, k, v, lo, slens, scale),
        "B3 bf16": lambda: paged.paged_flash_decode(q, kp, vp, table, plens,
                                                    scale),
        "B3 bf16 serving windows": lambda: paged.paged_flash_decode(
            q, kp, vp, table, slens, scale),
        "B3 int8": lambda: paged.paged_flash_decode(
            q, kq, vq, table, plens, scale, k_scale=ks, v_scale=vs),
        "B5": lambda: flash.flash_decode_quantized(
            q, dq, dvq, dks, dvs, pos, lens, sliding_window=256,
            scale=scale, logit_softcap=30.0)}


def core_variants(torch, unit_rows=(128, 256, 512), iters: int = 30):
    """Time the decode core's main cases (`_decode_main_cases`) as built
    at each of `unit_rows`, and, at the plan's UNIT_ROWS, in the scratch
    variants of `_CORE_EDITS` (each built with the port's nvcc flags and
    swapped in behind the same wrappers). Returns {variant: {case: ms}}.
    Run alone:

        python3 -c "import chip_smoke as c, torch; c.phase_device(torch);
            c.core_variants(torch)"
    """
    import ctypes
    import shutil

    from ome_tpu_torch.ops import _build, flash
    dev = torch.device("cuda")
    timer = Timer(torch, dev)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    _build.build(["flash_decode", "flash_paged_decode"])
    csrc = _build._CSRC
    root = os.path.join(OUT_DIR, "core_variants")
    shutil.rmtree(root, ignore_errors=True)
    procs = {}
    for variant, edits in _CORE_EDITS.items():
        vdir = os.path.join(root, str(len(procs) // 2))
        shutil.copytree(csrc, vdir)
        path = os.path.join(vdir, "decode_core.cuh")
        text = open(path).read()
        for old, new in edits:
            if text.count(old) != 1:
                fail(f"core variant {variant}: {old!r} not once")
            text = text.replace(old, new)
        open(path, "w").write(text)
        for src in ("flash_decode", "flash_paged_decode"):
            out = os.path.join(vdir, f"{src}.so")
            procs[(variant, src)] = (out, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-o", out,
                 os.path.join(vdir, f"{src}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    cases = _decode_main_cases(torch, gen)
    results = {}
    built = dict(_build._loaded)
    default_rows = flash.UNIT_ROWS
    for rows in unit_rows:
        flash.UNIT_ROWS = rows
        results[f"as built, unit_rows {rows}"] = {
            name: timer.ms(fn, iters) for name, fn in cases.items()}
    flash.UNIT_ROWS = default_rows
    for (variant, src), (out, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            fail(f"core variant {variant}: nvcc failed:\n{err}")
    for variant in _CORE_EDITS:
        for src in ("flash_decode", "flash_paged_decode"):
            out = procs[(variant, src)][0]
            symbol, argtypes = _build._SIGNATURES[src]
            fn = getattr(ctypes.CDLL(out), symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _build._loaded[src] = fn
        results[variant] = {name: timer.ms(fn, iters)
                            for name, fn in cases.items()}
    _build._loaded.update(built)
    results["timer floor (one tiny elementwise kernel)"] = timer.ms(
        lambda: torch.zeros(256, device=dev).add_(1.0), iters)
    # the card's read rate under this Timer: one torch reduction over as
    # many contiguous bytes as B3's and B1's main cases read
    for mb in (48, 31):
        x = torch.ones(mb << 19, dtype=torch.bfloat16, device=dev)
        results[f"torch sum over {mb} MB of bf16 (reads)"] = timer.ms(
            lambda: x.sum(), iters)
        del x
    for name, row in results.items():
        log(f"[core] {name}: {row}")
    return results


def _ab_cases(torch, timer, gen):
    """The main cases of B1 (bf16, fp32), B2 (causal 2048, the verify
    shape), B3 (bf16 and int8 pools) and B5: shapes every version of the
    kernels takes (G 4), for `kernels_ab`."""
    lengths = [0, 1, 17, 128, 300, 1023, 2049, 4095]
    pool = [1, 17, 128, 300, 1023, 2049, 4095, 4096]
    return [decode_case(torch, timer, gen, "bf16", lengths),
            decode_case(torch, timer, gen, "fp32", lengths),
            prefill_case(torch, timer, gen, "bf16", 2048, 2048, 0),
            prefill_case(torch, timer, gen, "bf16", 5, 4096, 0, B=8,
                         bases=VERIFY_BASES),
            paged_case(torch, timer, gen, "bf16", pool),
            paged_case(torch, timer, gen, "int8", pool),
            quantized_case(torch, timer, gen, lengths)]


def kernels_ab(torch, other_root: str):
    """The main cases of B1, B2, B3 and B5 (`_ab_cases`) with the
    `ome_tpu_torch` package under `other_root` (e.g. a `git archive` of
    an earlier commit) and with this checkout's, in turns in one call:
    other, this, this, other, each in a process of its own that builds
    its kernels. Returns {case: [ms, ms, ms, ms]}. (An earlier form of
    it timed every decode case; `DECODE_MS_BEFORE` comes from that run.)
    Run alone:

        python3 -c "import chip_smoke as c, torch; c.phase_device(torch);
            c.kernels_ab(torch, 'DIR')"
    """
    here = os.path.dirname(os.path.abspath(__file__))
    # this script's cases, loaded by path, over the package under root
    # (whose own chip_smoke.py is not the one imported)
    code = (
        "import sys, json, importlib.util; sys.path[:0] = [{root!r}]\n"
        "spec = importlib.util.spec_from_file_location('chip_smoke', "
        "{script!r})\n"
        "c = importlib.util.module_from_spec(spec)\n"
        "sys.modules['chip_smoke'] = c\n"
        "spec.loader.exec_module(c)\n"
        "import torch\n"
        "c.fail = lambda msg: print('NOTE ' + msg, flush=True)\n"
        "c.phase_build()\n"
        "g = torch.Generator(device='cuda'); g.manual_seed(0)\n"
        "t = c.Timer(torch, torch.device('cuda'))\n"
        "cases = c.check_cases({{'ab': c._ab_cases(torch, t, g)}})['ab']\n"
        "print('AB ' + json.dumps({{r['case']: r['ms'] for r in cases}}))\n")
    times = {}
    for root in (other_root, here, here, other_root):
        proc = subprocess.run(
            [sys.executable, "-c", code.format(
                root=os.path.abspath(root),
                script=os.path.abspath(__file__))],
            capture_output=True, text=True, timeout=900)
        line = [x for x in proc.stdout.splitlines() if x.startswith("AB ")]
        if proc.returncode != 0 or not line:
            fail(f"kernels_ab {root}: {proc.stderr[-2000:]}")
        # a check that fails is reported, and the case still timed; this
        # checkout's kernels must pass every check
        notes = [x for x in proc.stdout.splitlines() if x.startswith("NOTE ")]
        for note in notes:
            log(f"[ab] {root}: {note[5:]}")
        if notes and root == here:
            fail(f"kernels_ab: this checkout failed a check: {notes[0]}")
        for case, ms in json.loads(line[0][3:]).items():
            times.setdefault(case, []).append(ms)
    for case, row in times.items():
        log(f"[ab] {case}: other, this, this, other = {row}")
    return times


def serve_ab(torch, other_root: str):
    """`phase_serve` (the dense Llama-3-8B bf16 server, then its engine
    step times) with the `ome_tpu_torch` package under `other_root` (a
    `git archive` of an earlier commit) and with this checkout's, in
    turns in one call: other, this, this, other, each in a process of
    its own. Returns {metric: [value x 4]}: the decode step's and the
    cold 2048-token prefill's wall and device ms and idle share, and
    the served requests' TTFT and TPOT medians. Run alone:

        python3 -c "import chip_smoke as c, torch; c.phase_device(torch);
            c.serve_ab(torch, 'DIR')"
    """
    here = os.path.dirname(os.path.abspath(__file__))
    code = (
        "import sys, json, importlib.util; sys.path[:0] = [{root!r}]\n"
        "spec = importlib.util.spec_from_file_location('chip_smoke', "
        "{script!r})\n"
        "c = importlib.util.module_from_spec(spec)\n"
        "sys.modules['chip_smoke'] = c\n"
        "spec.loader.exec_module(c)\n"
        "import torch\n"
        "c.phase_build()\n"
        "r = c.phase_serve(torch)\n"
        "out = {{'ttft_median_ms': r['ttft_median_s'] * 1e3,\n"
        "       'tpot_median_ms': r['tpot_median_s'] * 1e3}}\n"
        "for step, v in r['step'].items():\n"
        "    for k in ('wall_ms', 'device_ms', 'idle_share'):\n"
        "        out[step + ' ' + k] = v[k]\n"
        "print('AB ' + json.dumps(out))\n")
    rows = {}
    os.makedirs(OUT_DIR, exist_ok=True)
    for turn, root in enumerate((other_root, here, here, other_root)):
        proc = subprocess.run(
            [sys.executable, "-c", code.format(
                root=os.path.abspath(root),
                script=os.path.abspath(__file__))],
            capture_output=True, text=True, timeout=900)
        # each turn's whole log (kernel and host tops of its steps)
        with open(os.path.join(OUT_DIR, f"serve_ab_{turn}.log"), "w") as f:
            f.write(f"# {root}\n{proc.stdout}{proc.stderr}")
        line = [x for x in proc.stdout.splitlines() if x.startswith("AB ")]
        if proc.returncode != 0 or not line:
            fail(f"serve_ab {root}: {proc.stderr[-2000:]}")
        for key, value in json.loads(line[0][3:]).items():
            rows.setdefault(key, []).append(value)
    for key, row in rows.items():
        log(f"[serve ab] {key}: other, this, this, other = {row}")
    return rows


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


# B1, B3 and B5 at each case with the split-KV kernels the decode core
# replaced (two launches per call, the CUDA cores): the mean of the two
# runs of that package in an earlier A/B's turns, on an NVIDIA H100 80GB
# HBM3 at 700 W; printed beside this run's. (On the int8 pool with NaN
# scales outside the windows those kernels gave non-finite output.)
DECODE_MS_BEFORE = {
    ('decode bf16 B=8 S=4096 H=32 K=8 D=128 lengths=[0, 1, 17, 128, '
     '300, 1023, 2049, 4095] window=None softcap=None'):
        0.0352,
    ('decode fp32 B=8 S=4096 H=32 K=8 D=128 lengths=[0, 1, 17, 128, '
     '300, 1023, 2049, 4095] window=None softcap=None'):
        0.0521,
    ('decode bf16 B=8 S=4096 H=32 K=8 D=128 lengths=[0, 1, 17, 128, '
     '300, 1023, 2049, 4095] window=256 softcap=30.0'):
        0.0173,
    ('decode bf16 B=8 S=4000 H=32 K=8 D=128 lengths=[4000, 3999, 4000, '
     '1000, 4000, 700, 300, 4000] window=256 softcap=None nan_outside'):
        0.0189,
    ('decode bf16 B=8 S=4000 H=32 K=8 D=128 lengths=[1, 17, 63, 64, '
     '300, 3999, 4000, 2049] window=None softcap=None nan_outside'):
        0.0431,
    ('decode bf16 B=8 S=4096 H=32 K=32 D=128 lengths=[0, 1, 17, 128, '
     '300, 1023, 2049, 4095] window=None softcap=None'):
        0.0710,
    ('decode bf16 B=8 S=4096 H=32 K=2 D=128 lengths=[0, 1, 17, 128, '
     '300, 1023, 2049, 4095] window=None softcap=None'):
        0.0355,
    ('decode bf16 B=8 S=4096 H=32 K=8 D=64 lengths=[0, 1, 17, 128, 300, '
     '1023, 2049, 4095] window=None softcap=None'):
        0.0247,
    ('paged bf16 B=8 H=32 K=8 D=128 bs=128 M=32 N=257 lengths=[1, 17, '
     '128, 300, 1023, 2049, 4095, 4096] trash_slot=None'):
        0.0468,
    ('paged fp32 B=8 H=32 K=8 D=128 bs=128 M=32 N=257 lengths=[1, 17, '
     '128, 300, 1023, 2049, 4095, 4096] trash_slot=None'):
        0.0669,
    ('paged int8 B=8 H=32 K=8 D=128 bs=128 M=32 N=257 lengths=[1, 17, '
     '128, 300, 1023, 2049, 4095, 4096] trash_slot=None'):
        0.0400,
    ('paged bf16 B=8 H=32 K=8 D=128 bs=128 M=32 N=257 lengths=[1, 17, '
     '128, 300, 1023, 2049, 4095, 5000] trash_slot=7'):
        0.0430,
    ('paged bf16 B=8 H=32 K=8 D=128 bs=128 M=32 N=257 lengths=[1, 17, '
     '128, 300, 1023, 2049, 4095, 4096] trash_slot=None nan_outside'):
        0.0465,
    ('paged bf16 B=16 H=32 K=8 D=128 bs=128 M=32 N=513 lengths=[1, 5, '
     '64, 100, 257, 512, 700, 1000, 1500, 2048, 2500, 3000, 3500, 4000, '
     '4095, 4096] trash_slot=None'):
        0.0744,
    ('paged bf16 B=8 H=32 K=8 D=128 bs=32 M=128 N=1025 lengths=[1, 17, '
     '128, 300, 1023, 2049, 4095, 4096] trash_slot=None'):
        0.0463,
    ('paged bf16 B=8 H=32 K=2 D=64 bs=64 M=64 N=513 lengths=[1, 17, '
     '128, 300, 1023, 2049, 4095, 4096] trash_slot=None'):
        0.0308,
    ('int8 dense B=8 S=4096 H=32 K=8 D=128 lengths=[0, 1, 17, 128, 300, '
     '1023, 2049, 4095] window=256 softcap=30.0'):
        0.0322,
}


# tolerance of B4 against its plain version (fp32 output), relative to
# max |y|: fp32 output differs only in summation order; bf16 output adds
# the rounding of y to bf16 (half an ulp, at most 2^-8 of |y|) and can
# land on either side of a rounding boundary: one ulp, 2^-7 of max |y|
INT4_RTOL = {"fp32": 1e-4, "bf16": 2 ** -7}


# B4's time at each case with the kernel this one replaced (cp.async,
# split-K combined by a second kernel), measured on an NVIDIA H100 80GB
# HBM3 at 700 W by this script's int4 cases; printed beside this run's
INT4_MS_BEFORE = {
    "int4 w_gate m=8 K=4096 N=14336 G=128 out=bf16": 0.0415,
    "int4 w_gate m=1 K=4096 N=14336 G=128 out=bf16": 0.0408,
    "int4 w_gate m=5 K=4096 N=14336 G=128 out=bf16": 0.0413,
    "int4 w_gate m=16 K=4096 N=14336 G=128 out=bf16": 0.0437,
    "int4 w_gate m=256 K=4096 N=14336 G=128 out=bf16": 0.2753,
    "int4 wq m=1 K=4096 N=4096 G=128 out=bf16": 0.0173,
    "int4 wq m=5 K=4096 N=4096 G=128 out=bf16": 0.0167,
    "int4 wq m=8 K=4096 N=4096 G=128 out=bf16": 0.017,
    "int4 wq m=16 K=4096 N=4096 G=128 out=bf16": 0.0177,
    "int4 wq m=256 K=4096 N=4096 G=128 out=bf16": 0.085,
    "int4 wk m=1 K=4096 N=1024 G=128 out=bf16": 0.0132,
    "int4 wk m=5 K=4096 N=1024 G=128 out=bf16": 0.0124,
    "int4 wk m=8 K=4096 N=1024 G=128 out=bf16": 0.0135,
    "int4 wk m=16 K=4096 N=1024 G=128 out=bf16": 0.0137,
    "int4 wk m=256 K=4096 N=1024 G=128 out=bf16": 0.0332,
    "int4 w_gate m=8 K=4096 N=14336 G=128 out=fp32": 0.0426,
    "int4 w_gate m=17 K=4096 N=14336 G=128 out=bf16": 0.0754,
    "int4 w_gate m=64 K=4096 N=14336 G=128 out=bf16": 0.0833,
    "int4 w_gate m=128 K=4096 N=14336 G=128 out=bf16": 0.1516,
    "int4 w_down m=8 K=14336 N=4096 G=128 out=bf16": 0.0379,
}


def int4_case(torch, timer, gen, weights, name, m, K, N, out_name="bf16",
              repeat_bits=False):
    """B4 at one projection shape: x [m, K] bf16 (the serving dtype)
    against a [K, N] weight quantized by the port's own
    `quantize_tensor_int4` (std 0.02, as the model init), group 128;
    `weights` caches each shape's weight and yardsticks across cases.
    `repeat_bits`: a second launch on the same inputs must give the same
    bits (the split-K sum has a fixed order)."""
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
    label = f"int4 {name} m={m} K={K} N={N} G=128 out={out_name}"
    if not torch.isfinite(out.float()).all():
        fail(f"int4_matmul {name} m={m}: non-finite output")
    same_bits = None
    if repeat_bits:
        same_bits = bool(torch.equal(out, kernel()))
        if not same_bits:
            fail(f"int4_matmul {label}: two launches on the same inputs "
                 f"gave different bits")
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
    bound = _bound(nbytes, 2 * m * K * N, "bf16")
    return {"case": label, "max_abs_err": err, "atol": atol, "ms": ms,
            "plain_ms": plain_ms, "library_ms": lib_ms,
            "library_err": lib_err, "library_why": lib_why,
            "bf16_mm_ms": bf16_mm_ms, "same_bits": same_bits,
            "ms_before": INT4_MS_BEFORE.get(label),
            "share_of_bound": bound["bound_ms"] / ms, **bound}


def phase_int4_kernel(torch, timer, gen):
    """B4 against its plain version at the Llama-3-8B projection shapes
    (K 4096; w_gate/w_up N 14336, wq N 4096, wk/wv N 1024) at decode and
    short-prefill batch sizes, the wide variant's edges (m 17, 64, 128)
    and w_down's shape (K 14336, N 4096: the longest K, the most splits;
    int8 in serving). The main case, first, is w_gate at m = 8; it and
    wk at m = 1 (the most splits per column tile) must repeat their bits
    from launch to launch."""
    weights = {}
    shapes = (("w_gate", 4096, 14336), ("wq", 4096, 4096),
              ("wk", 4096, 1024))
    cases = [int4_case(torch, timer, gen, weights, "w_gate", 8, 4096,
                       14336, repeat_bits=True)]
    for name, K, N in shapes:
        for m in (1, 5, 8, 16, 256):
            if (name, m) != ("w_gate", 8):
                cases.append(int4_case(torch, timer, gen, weights, name, m,
                                       K, N, repeat_bits=(name, m) == (
                                           "wk", 1)))
    cases.append(int4_case(torch, timer, gen, weights, "w_gate", 8, 4096,
                           14336, out_name="fp32"))
    for m in (17, 64, 128):
        cases.append(int4_case(torch, timer, gen, weights, "w_gate", m,
                               4096, 14336))
    cases.append(int4_case(torch, timer, gen, weights, "w_down", 8, 14336,
                           4096))
    why = weights[(4096, 14336)]["lib"][1]
    if why:
        log(f"[kernels] int4_matmul: no library_ms: "
            f"torch.ops.aten._weight_int4pack_mm failed ({why})")
    for c in cases:
        before = ("not measured" if c["ms_before"] is None
                  else f"{c['ms_before']:.4f} ms")
        log(f"[kernels] int4_matmul {c['case']}: share of bound "
            f"{c['share_of_bound']:.3f}; before {before}; bf16 torch.mm "
            f"over the dequantized weight {c['bf16_mm_ms']:.4f} ms; "
            f"_weight_int4pack_mm err {c['library_err']}"
            + ("" if c["same_bits"] is None else
               f"; two launches bitwise equal {c['same_bits']}"))
    del weights
    return {"int4_matmul": cases}


def phase_kernels(torch):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    timer = Timer(torch, torch.device("cuda"))
    cases = phase_decode_kernels(torch, timer, gen)
    cases.update(phase_prefill_kernel(torch, timer, gen))
    cases.update(phase_paged_kernels(torch, timer, gen))
    cases.update(phase_int4_kernel(torch, timer, gen))
    return check_cases(cases)


def check_cases(cases):
    """Log every case of every kernel; fail if one disagrees with its
    plain version."""
    bad = []
    for name, rows in cases.items():
        for c in rows:
            ok = c["max_abs_err"] <= c["atol"]
            rel = ""
            if "rel_errs" in c:
                ok = ok and max(c["rel_errs"]) <= c["rel_tol"]
                rel = (f"; max_abs_err / rms of the plain output, per "
                       f"sequence, "
                       f"{' '.join(f'{r:.3e}' for r in c['rel_errs'])} "
                       f"(tol {c['rel_tol']:.3g})")
            lib = ("null" if c["library_ms"] is None
                   else f"{c['library_ms']:.4f}")
            log(f"[kernels] {name} {c['case']}: max_abs_err "
                f"{c['max_abs_err']:.3e} (tol {c['atol']:.3g}){rel} "
                f"{'ok' if ok else 'FAIL'}; ms {c['ms']:.4f} plain_ms "
                f"{c['plain_ms']:.4f} bound_ms {c['bound_ms']:.4f} "
                f"({c['bound_by']}) library_ms {lib}")
            if not ok:
                bad.append(f"{name}: {c['case']}")
    if bad:
        fail("kernel disagrees with its plain version: " + "; ".join(bad))
    return cases


# -- phase 4: serve -----------------------------------------------------------


def _hf_config(cfg) -> dict:
    return {"architectures": ["LlamaForCausalLM"], "model_type": "llama",
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


def _http(url: str, method: str = "GET", body=None, timeout: float = 600):
    """(status, headers, body bytes) of one request; an HTTP error status
    is returned, not raised."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(
        url, method=method,
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        with e:
            return e.code, dict(e.headers), e.read()


def _scrape(url: str) -> dict:
    """{sample with its labels: value} of one /metrics scrape (which
    refreshes the scheduler's gauges, the HBM partition among them)."""
    status, _, raw = _http(url + "/metrics")
    if status != 200:
        fail(f"/metrics: HTTP {status}")
    out = {}
    for line in raw.decode().splitlines():
        if line and not line.startswith("#"):
            key, _, val = line.rpartition(" ")
            out[key] = float(val)
    return out


@contextlib.contextmanager
def _first_logits(engine):
    """Inside the block, record the logits of the engine's first
    sampling (a prefill's: the step that samples a stream's first token)
    as a float32 CPU tensor [V] in the yielded list. A tp leader's
    ReplicatedEngine is read through its own rank's engine, whose
    logits are gathered whole."""
    inner = getattr(engine, "_engine", engine)
    got, sample = [], inner._sample

    def recording(logits, *a):
        if not got:
            got.append(logits[0].float().cpu())
        return sample(logits, *a)
    inner._sample = recording
    try:
        yield got
    finally:
        del inner._sample


# the prompt whose first-step logits phases 4 and 43 compare (tp=2 against
# tp=1, bf16, the same weights)
GAP_PROMPT_LEN = 64


def _gap_logits(url, engine, sched, seed: int, vocab: int, tag: str):
    """The first-step logits of the gap prompt, sent alone to an idle
    server."""
    import random
    rng = random.Random(seed + 43)
    ids = [rng.randrange(3, vocab) for _ in range(GAP_PROMPT_LEN)]
    _wait_idle(sched)
    with _first_logits(engine) as got:
        _completion(*_post(url, {"prompt": ids, "max_tokens": 1,
                                 "temperature": 0.0}), 1, "gap prompt")
    if not got:
        fail(f"{tag}: the gap prompt's prefill sampled nothing")
    return got[0]


# kernel-name fragments of B1 (the dense decode core) and B2 (bf16
# prefill) in a torch.profiler trace
TRACE_KERNELS = {"flash_decode": "decode_tc", "flash_prefill": "prefill_wgmma"}


def _trace_kernels(path: str) -> dict:
    """{kernel: launches} counted from a Chrome trace's kernel events."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    counts = dict.fromkeys(TRACE_KERNELS, 0)
    counts["all_kernels"] = 0
    for ev in events:
        if ev.get("cat") != "kernel":
            continue
        counts["all_kernels"] += 1
        for name, frag in TRACE_KERNELS.items():
            if frag in ev.get("name", ""):
                counts[name] += 1
    return counts


def _attribution(torch, url, engine, prompt, tag):
    """Performance attribution of a live server launched with
    --debug-endpoints and --profile-dir: the program ledger's entries
    (each must be counted on the card), the HBM partition beside the
    allocator's own numbers, the online roofline, and a 2-second
    profile taken while a stream decodes (B1 must be in the trace, and
    B2 where a prefill fell inside the window; a second concurrent
    capture must get 409)."""
    out = {}
    status, _, raw = _http(url + "/debug/programs")
    if status != 200:
        fail(f"{tag}: GET /debug/programs: HTTP {status}")
    doc = json.loads(raw)
    keys = ("program", "source", "flops", "bytes", "expected_ms",
            "dispatches", "argument_bytes", "output_bytes")
    out["programs"] = [{k: e[k] for k in keys} for e in doc["programs"]]
    log(f"{tag} /debug/programs: mode {doc['mode']}, {doc['count']} "
        f"programs, device {doc['device']}")
    for e in out["programs"]:
        log(f"{tag}   {e['program']}: source {e['source']}, flops "
            f"{e['flops']:.6g}, bytes {e['bytes']:.6g}, expected_ms "
            f"{e['expected_ms']:.4f}, dispatches {e['dispatches']}")
    bad = [e["program"] for e in out["programs"] if e["source"] != "counted"]
    if bad or not out["programs"]:
        fail(f"{tag}: ledger entries not counted on the card: {bad}")

    m = _scrape(url)
    part = {t: m[f'ome_engine_hbm_tenant_bytes{{tenant="{t}"}}']
            for t in ("weights", "kv_cache", "prefix_cache", "workspace")}
    for k in ("bytes_in_use", "bytes_limit", "peak_bytes"):
        part[k] = m[f"ome_engine_hbm_{k}"]
    out["hbm"] = part
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    out["memory_reserved"] = torch.cuda.memory_reserved()
    log(f"{tag} HBM partition (/metrics, GB): " + ", ".join(
        f"{k} {v / 1e9:.3f}" for k, v in part.items())
        + f"; torch.cuda.max_memory_allocated {out['max_memory_allocated'] / 1e9:.3f}"
        f", memory_reserved {out['memory_reserved'] / 1e9:.3f}")
    out["roofline_efficiency"] = m["ome_engine_roofline_efficiency"]
    out["step_achieved_gbps"] = m["ome_engine_step_achieved_gbps"]
    log(f"{tag} ome_engine_roofline_efficiency {out['roofline_efficiency']:.4f}"
        f" (the ledger's expected ms over the last decode dispatch's wall "
        f"time); ome_engine_step_achieved_gbps "
        f"{out['step_achieved_gbps']:.1f}")

    # the profile: a stream decodes, a capture starts, a second capture
    # meets it, a prefill lands inside the window
    decoding = threading.Event()
    streamed = []

    def stream():
        # 96 tokens outlast the 2 s window (a step takes 50-80 ms here)
        st, _, raw = _http(url + "/v1/completions", "POST",
                           {"prompt": prompt(64), "max_tokens": 96,
                            "temperature": 0.0, "stream": True})
        streamed.append((st, raw.count(b"data: ")))
    t_stream = threading.Thread(target=stream)
    t_stream.start()
    # a 64-token prefill arms its slot well within half a second
    time.sleep(0.5)
    got = {}

    def capture():
        got["first"] = _http(url + "/debug/profile?seconds=2", "POST")
    t_cap = threading.Thread(target=capture)
    t0 = time.monotonic()
    t_cap.start()
    time.sleep(0.3)
    second = _http(url + "/debug/profile?seconds=1", "POST")
    time.sleep(0.3)
    pre = _http(url + "/v1/completions", "POST",
                {"prompt": prompt(300), "max_tokens": 2,
                 "temperature": 0.0})
    prefill_in_window = time.monotonic() - t0 < 1.9
    t_cap.join(timeout=120)
    t_stream.join(timeout=600)
    status, _, raw = got.get("first", (None, None, b"{}"))
    if status != 200:
        fail(f"{tag}: POST /debug/profile: HTTP {status} {raw[:200]!r}")
    res = json.loads(raw)
    if not res.get("captured") or not os.path.exists(res.get("trace", "")):
        fail(f"{tag}: the profile wrote no trace: {res}")
    if second[0] != 409 or second[1].get("Retry-After") != "1":
        fail(f"{tag}: a concurrent capture got HTTP {second[0]}, not 409 "
             f"with Retry-After")
    if pre[0] != 200 or not streamed or streamed[0][0] != 200:
        fail(f"{tag}: requests during the profile failed: {pre[0]}, "
             f"{streamed}")
    counts = _trace_kernels(res["trace"])
    out["profile"] = {"seconds": res["seconds"], "kernels": counts,
                      "trace_bytes": os.path.getsize(res["trace"]),
                      "second_capture": second[0],
                      "prefill_in_window": prefill_in_window,
                      "stream_events": streamed[0][1],
                      "programs": len(res.get("programs", []))}
    # the trace holds every kernel of the window (tens of MB): counted,
    # then removed so that it does not travel back with the outputs
    os.remove(res["trace"])
    log(f"{tag} POST /debug/profile?seconds=2 while a stream decodes: "
        f"{res['seconds']} s captured, trace {out['profile']['trace_bytes']}"
        f" bytes; kernel events {counts}; prefill inside the window "
        f"{prefill_in_window}; a concurrent POST got {second[0]}")
    if counts["flash_decode"] <= 0:
        fail(f"{tag}: the profile's trace holds no B1 launch: {counts}")
    if prefill_in_window and counts["flash_prefill"] <= 0:
        fail(f"{tag}: a prefill fell inside the profile but the trace "
             f"holds no B2 launch: {counts}")
    return out


def _export_spans(path: str, tag: str) -> dict:
    """The server's span log through the port's exporter: tracks, spans
    and events of the Chrome trace, written beside the other outputs."""
    from ome_tpu_torch.telemetry import export
    spans = export.load_spans([path])
    doc = export.build_trace(spans)
    tracks = sum(1 for e in doc["traceEvents"]
                 if e["ph"] == "M" and e["name"] == "process_name")
    os.makedirs(OUT_DIR, exist_ok=True)
    dest = os.path.join(OUT_DIR, "serve_spans_trace.json")
    with open(dest, "w") as f:
        json.dump(doc, f, separators=(",", ":"))
    out = {"tracks": tracks, "spans": doc["otherData"]["span_count"],
           "traces": len(export.trace_ids(spans)),
           "events": len(doc["traceEvents"])}
    log(f"{tag} span log exported (ome_tpu_torch.telemetry.export): "
        f"{out['tracks']} track(s), {out['spans']} spans over "
        f"{out['traces']} traces, {out['events']} trace events -> {dest}")
    if not out["spans"]:
        fail(f"{tag}: the span log holds no span")
    return out


def _device_profile(torch, fn, iters: int, match: str = None):
    """Summed device time per call of `fn` and its five costliest
    device operations (ms per call, launches per call, name), from
    torch.profiler's CUDA activity; and on the host side, the top-level
    aten operators per call and the five with the most self CPU time
    (ms per call, calls per call, name); and every device operation
    whose name `match` (a regular expression) matches, as (ms per call,
    launches per call, name): [] without `match`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    from ome_tpu_torch.telemetry.profiler import session
    with session([ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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
    return (sum(r[0] for r in rows), rows[:5], host[:5],
            [r for r in rows if match and re.search(match, r[2])])


def weight_label(params) -> str:
    """The weight mode of a parameter tree: bf16 (or float32), int8,
    fp8 or int4."""
    import torch
    from ome_tpu_torch.models.quant import QTensor
    lay = params["layers"]
    wq = lay["wq"] if "wq" in lay else lay["wq_a"]  # MLA with q LoRA
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

    from ome_tpu_torch.ops import flash
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
        busy, top, host, _ = _device_profile(torch, fn, 3)
        n0 = dict(flash.LAUNCHES)
        fn()
        torch.cuda.synchronize()
        res[name] = {"wall_ms": wall, "device_ms": busy or None,
                     "idle_share": 1 - busy / wall if busy else None,
                     "top": top, "host_top": host,
                     "launches": {k: flash.LAUNCHES[k] - n0[k] for k in n0}}
        if busy:
            before = (f" (mma.sync prefill kernel: "
                      f"{PREFILL_2048_DEVICE_MS_BEFORE} ms)"
                      if name == "prefill_2048" and what == "dense" else "")
            log(f"[serve] {what} engine {name} step: wall {wall:.2f} ms, "
                f"device busy {busy:.2f} ms (torch.profiler){before}, idle "
                f"share {1 - busy / wall:.2f}; B1 / B2 launches "
                f"{res[name]['launches']['flash_decode']} / "
                f"{res[name]['launches']['flash_prefill']}")
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


def _model_hf(model):
    """(HF config dict, label, ModelConfig) of a phase's model: the
    Llama-3-8B shape unless `model` names another (a dict with "hf",
    "label" and optionally "bias_std", "layers")."""
    from ome_tpu_torch.models.config import ModelConfig, llama3_8b
    if model is None:
        cfg = llama3_8b()
        return _hf_config(cfg), "Llama-3-8B", cfg
    hf = dict(model["hf"])
    if model.get("layers"):
        hf["num_hidden_layers"] = model["layers"]
    return hf, model["label"], ModelConfig.from_hf_config(hf)


def _randomize_biases(torch, engine, seed: int, std: float) -> None:
    """Replace the init's zero q/k/v biases with seeded N(0, std) values
    in place, so that a wrong bias term shows in the output."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 77)
    lay = engine.model.params["layers"]
    for name in ("bq", "bk", "bv"):
        t = lay[name]
        t.copy_(torch.randn(t.shape, generator=gen, device=t.device)
                .mul_(std))


def phase_serve(torch, seed: int = 0, quantization: str = "none",
                model=None, attribution: bool = False):
    """The dense server at the Llama-3-8B shape, bf16 weights or
    `--quantization int4` (whose decode steps and prefills of up to 256
    tokens run B4, and whose longer prefills take the dequantizing
    route); or, with `model`, another published configuration in bf16
    (its q/k/v biases drawn non-zero where it has them; a MoE model also
    reports its MoE block's device time and the experts a decode step
    reads). With `attribution` (phase 4) the server also runs with
    --debug-endpoints, --profile-dir and --span-log: its program ledger,
    HBM partition, online roofline and a profile (`_attribution`), the
    first-step logits of the gap prompt (phase 43 compares tp=2's), the
    ledger's expected ms beside the profiler's device ms of the decode
    and 2048-token prefill programs, and its span log exported."""
    import concurrent.futures
    import random
    import tempfile
    import urllib.request

    from ome_tpu_torch.engine import serve
    from ome_tpu_torch.models.quant import quantized_bytes
    from ome_tpu_torch.ops import flash

    hf, name, cfg = _model_hf(model)
    rng = random.Random(seed)
    tag = "[serve]" if model is None else f"[serve {name}]"
    if quantization != "none":
        tag = f"{tag[:-1]} {quantization}]"

    def prompt(n):
        return [rng.randrange(3, cfg.vocab_size) for _ in range(n)]

    out = {"quantization": quantization, "model": name,
           "layers": cfg.num_layers}
    model = model or {}
    max_seq = model.get("max_seq", 4096)
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "config.json"), "w") as f:
            json.dump(hf, f)
        reqlog = os.path.join(tmp, "requests.jsonl")
        spans = os.path.join(tmp, "spans.jsonl")
        extra = ["--debug-endpoints", "--span-log", spans, "--profile-dir",
                 os.path.join(OUT_DIR, "profile")] if attribution else []
        t0 = time.monotonic()
        server, sched, engine = serve.build_server(
            ["--model-dir", tmp, "--random-weights", "--seed", str(seed),
             "--max-slots", "8", "--max-seq", str(max_seq), "--port", "0",
             "--host", "127.0.0.1", "--request-log", reqlog,
             "--quantization", quantization] + extra)
        if model.get("bias_std"):
            _randomize_biases(torch, engine, seed, model["bias_std"])
        if model.get("seed_leaves"):
            _seed_family_leaves(torch, engine.model.params, cfg, seed)
        if cfg.is_moe and engine.cfg.moe_impl != "ragged":
            fail(f"{tag}: the MoE server runs moe_impl "
                 f"{engine.cfg.moe_impl!r}, not the ragged dispatch")
        torch.cuda.synchronize()
        out["startup_s"] = time.monotonic() - t0
        out["device_gib_after_startup"] = torch.cuda.memory_allocated() / 2**30
        out["weight_bytes"] = quantized_bytes(engine.model.params)
        log(f"{tag} {name} shape, random "
            f"{weight_label(engine.model.params)} weights (seed {seed}), "
            f"{cfg.num_layers} layers, slots 8, max_seq {max_seq}: server up "
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
            lengths = model.get("lengths") or [16, 100, 400, 800, 1500,
                                               2200, 2600, 3000]
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
            # each batch request's tokens, in body order (phase 43 holds
            # the tp 2 server's against them)
            out["streams"] = [next(list(r.output_ids) for r in seen
                                   if r.prompt_ids == b["prompt"])
                              for b in bodies]
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
            if attribution:
                out["attribution"] = _attribution(torch, url, engine, prompt,
                                                  tag)
                # a CPU tensor, popped by phase 43 (not in the JSON report)
                out["gap_logits"] = _gap_logits(url, engine, sched, seed,
                                                cfg.vocab_size, tag)
        finally:
            server.stop()
        out["step"] = _step_times(torch, engine, prompt)
        if attribution:
            progs = {e["program"]: e for e in engine.ledger.snapshot()}
            rows = {}
            for name, key in (("decode", "decode"),
                              ("prefill_2048", "prefill[bucket=2048]")):
                e, st = progs.get(key), out["step"][name]
                if e is None:
                    fail(f"{tag}: the ledger has no {key} entry")
                rows[key] = {"expected_ms": e["expected_ms"],
                             "device_ms": st["device_ms"],
                             "wall_ms": st["wall_ms"],
                             "flops": e["flops"], "bytes": e["bytes"]}
                log(f"{tag} ledger {key}: expected_ms {e['expected_ms']:.4f}"
                    f" (flops {e['flops']:.6g} counted, bytes "
                    f"{e['bytes']:.6g} modelled) against the profiler's "
                    f"device {st['device_ms']} ms (wall {st['wall_ms']:.3f} "
                    f"ms)")
            out["attribution"]["expected_vs_device"] = rows
            out["attribution"]["spans"] = _export_spans(spans, tag)
        if cfg.is_moe:
            out["moe"] = _moe_profile(torch, engine, prompt)
        with open(reqlog) as f:
            recs = [json.loads(line) for line in f]
    out["launches"] = launches
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
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
    log(f"{tag} kernel launches while serving: {launches}; peak device "
        f"memory {out['peak_gib']:.2f} GiB")
    return out


def _moe_profile(torch, engine, prompt):
    """A served MoE model's expert dispatch on the card: the grouped
    product (`torch._grouped_mm`) against its plain version at the decode
    step's and a 2048-token prefill's rows (one expert given no rows);
    the MoE block's device time per layer at both (torch.profiler, layer
    0's weights, random normal inputs); and the experts a decode step of
    the armed slots hits per layer (router picks recorded in one step),
    with the expert bytes that step reads."""
    import numpy as np

    from ome_tpu_torch.models import llama
    cfg, dev = engine.cfg, torch.device("cuda")
    lp = {n: t[0] for n, t in engine.model.params["layers"].items()}
    D, E, k = cfg.hidden_size, cfg.num_experts, cfg.experts_per_token
    Fm = cfg.moe_intermediate_size or cfg.intermediate_size
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    timer = Timer(torch, dev)
    out = {"grouped": [], "block": {}}
    for rows in (engine.max_slots * k, 2048 * k):
        ids = torch.randint(0, E - 1, (rows,), generator=gen, device=dev)
        ids = ids + (ids >= 3).long()       # expert 3 gets no rows
        ids = torch.sort(ids).values
        offs = (ids[:, None] == torch.arange(E, device=dev)).sum(0) \
            .cumsum(0).to(torch.int32)
        xs = torch.randn(rows, D, generator=gen, device=dev).to(
            torch.bfloat16)
        w = lp["we_gate"]
        got = llama._grouped(xs, w, ids, offs)
        ref = llama.grouped_ref(xs.float(), w.float(), ids)
        torch.cuda.synchronize()
        err = (got.float() - ref).abs().max().item()
        case = {"rows": rows, "max_abs_err": err, "atol": ATOL["bf16"],
                "ms": timer.ms(lambda: llama._grouped(xs, w, ids, offs)),
                "plain_bf16_ms": timer.ms(
                    lambda: llama.grouped_ref(xs, w, ids), iters=5)}
        out["grouped"].append(case)
        log(f"[moe] torch._grouped_mm x we_gate [{E}, {D}, {Fm}] at "
            f"{rows} rows (expert 3 empty): max_abs_err {err:.3e} (tol "
            f"{ATOL['bf16']}); {case['ms']:.4f} ms, plain bf16 loop "
            f"{case['plain_bf16_ms']:.4f} ms")
        if not err <= ATOL["bf16"]:
            fail(f"moe: torch._grouped_mm disagrees with its plain "
                 f"version at {rows} rows ({err:.3e})")
    # a decode step of the model (all layers, the ragged dispatch) makes
    # no host sync: torch's sync debug mode raises on any
    cache = llama.KVCache.create(cfg, engine.max_slots, 256, device=dev)
    cache.index = torch.arange(engine.max_slots, dtype=torch.int32,
                               device=dev) * 20 + 7
    toks = torch.randint(3, cfg.vocab_size, (engine.max_slots, 1),
                         generator=gen, device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        llama.forward(engine.model.params, cfg, toks, cache=cache,
                      freqs=engine.model.freqs)
    except RuntimeError as e:
        fail(f"moe: a decode step synchronized with the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    del cache
    log("[moe] a decode step through the ragged dispatch ran under "
        "torch.cuda.set_sync_debug_mode('error'): no host sync")
    for what, shape in (("decode", (engine.max_slots, 1)),
                        ("prefill_2048", (1, 2048))):
        h = torch.randn(*shape, D, generator=gen, device=dev).to(cfg.dtype)

        def block():
            return llama.moe_mlp(h, lp, cfg)
        block()
        torch.cuda.synchronize()
        busy, top, _, _ = _device_profile(torch, block, 5)
        out["block"][what] = {"device_ms": busy, "top": top}
        log(f"[moe] MoE block ({cfg.moe_impl}), one layer, {what} "
            f"{shape[0] * shape[1]} tokens: device {busy:.3f} ms "
            f"(torch.profiler)")
        for ms, count, key in top:
            log(f"[moe]   {ms:8.3f} ms  x{count:<4d} {key[:90]}")
    # the experts one decode step hits, layer by layer
    state = engine.new_state()
    for slot in range(engine.max_slots):
        tok, kv, n, bucket = engine.prefill(prompt(64 + 300 * slot))
        state = engine.insert(state, kv, slot, n, tok, bucket)
    greedy = (np.zeros(engine.max_slots, np.float32),
              np.zeros(engine.max_slots, np.int32),
              np.ones(engine.max_slots, np.float32))
    picks = []
    route = llama._route

    def recording_route(x, p, c):
        weights, idx = route(x, p, c)
        picks.append(idx.reshape(-1))
        return weights, idx
    llama._route = recording_route
    try:
        engine.decode(state, *greedy)
        torch.cuda.synchronize()
    finally:
        llama._route = route
    hits = [int(torch.unique(i).numel()) for i in picks]
    per_expert = 3 * D * Fm * 2
    expert_bytes = sum(hits) * per_expert
    # the step's least traffic: the experts hit, every other weight but
    # the embedding table (of which it reads one row per slot), and the
    # K/V rows of the armed slots (prompt + the new token)
    lay = engine.model.params["layers"]
    other = sum(t.numel() * t.element_size() for n, t in lay.items()
                if not n.startswith("we_"))
    other += sum(t.numel() * t.element_size() for n, t in
                 engine.model.params.items() if n not in ("layers", "embed"))
    other += engine.max_slots * D * 2
    rows = sum(64 + 300 * slot + 1 for slot in range(engine.max_slots))
    kv_bytes = rows * cfg.num_layers * cfg.num_kv_heads * cfg.head_dim * 4
    step_bytes = expert_bytes + other + kv_bytes
    out.update(experts_hit=hits, mean_hit=statistics.mean(hits),
               expert_bytes_per_step=expert_bytes,
               step_bytes=step_bytes,
               step_bound_ms=step_bytes / HBM_BYTES_PER_S * 1e3)
    log(f"[moe] decode step of {engine.max_slots} slots: experts hit per "
        f"layer {hits} (mean {out['mean_hit']:.2f} of {E}); expert bytes "
        f"read {expert_bytes / 1e9:.3f} GB, other weights "
        f"{other / 1e9:.3f} GB, K/V {kv_bytes / 1e9:.3f} GB: byte bound "
        f"of the step {out['step_bound_ms']:.2f} ms")
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
                      first_tokens=None, model=None, kv_block: int = 128):
    """The paged server at the Llama-3-8B shape: `--kv-block 128
    --max-slots 16 --max-seq 4096 --kv-blocks 129` (128 usable blocks,
    16384 rows: a quarter of the dense-equivalent 512 blocks), in bf16
    or int8. bf16: 16 concurrent completions whose prompts fill about
    3/4 of the pool plus two twins, then a burst larger than the pool
    (admission backpressure, preemption); int8: the first-token
    prompts, whose first tokens must equal the bf16 server's. With
    `model`, another published configuration (see `phase_serve`) on the
    bf16 pool; `kv_block` another block size over the same 16384
    rows."""
    import concurrent.futures
    import random
    import tempfile

    from ome_tpu_torch.engine import serve
    from ome_tpu_torch.ops import flash

    hf, name, cfg = _model_hf(model)
    rng = random.Random(seed + 1)

    def prompt(n):
        return [rng.randrange(3, cfg.vocab_size) for _ in range(n)]

    out = {"kv_dtype": kv_dtype, "model": name, "kv_block": kv_block,
           "layers": cfg.num_layers}
    tag = f"[paged {kv_dtype}]" if model is None else \
        f"[paged {kv_dtype} {name}]"
    n_blocks = 16384 // kv_block + 1
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "config.json"), "w") as f:
            json.dump(hf, f)
        t0 = time.monotonic()
        server, sched, engine = serve.build_server(
            ["--model-dir", tmp, "--random-weights", "--seed", str(seed),
             "--max-slots", "16", "--max-seq", "4096", "--kv-block",
             str(kv_block), "--kv-blocks", str(n_blocks), "--kv-dtype",
             kv_dtype, "--port", "0",
             "--host", "127.0.0.1"])
        if model and model.get("bias_std"):
            _randomize_biases(torch, engine, seed, model["bias_std"])
        torch.cuda.synchronize()
        out["startup_s"] = time.monotonic() - t0
        out["device_gib_after_startup"] = torch.cuda.memory_allocated() / 2**30
        log(f"{tag} {name} shape, seed {seed}, slots 16, "
            f"max_seq 4096, kv_block {kv_block}, kv_blocks {n_blocks} "
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
                log(f"{tag} 16 concurrent completions (prompts "
                    f"{sum(lengths)} tokens, 3/4 of the pool's 16384 rows) "
                    f"+ 2 twins: all 200, "
                    f"{out['batch_completion_tokens']} tokens in "
                    f"{out['batch_s']:.2f} s; twins identical")
                # 2040-token prompts fill 2048 / kv_block blocks each and
                # need one more at their 9th token: with the pool full of
                # them, decode growth has to preempt
                burst = [{"prompt": prompt(2040), "max_tokens": 32,
                          "temperature": 0.0} for _ in range(12)]
                t_burst = time.monotonic()
                post_all(burst, "burst request")
                out["burst_s"] = time.monotonic() - t_burst
                log(f"{tag} burst of 12 x 2040-token prompts (24480 "
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
    log(f"{tag} idle: kv_conservation {ok} (owned {owned}), "
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


def phase_step_turns(torch, seed: int = 0, rounds: int = 2,
                     n_layers: int = CUT_LAYERS):
    """The decode step of the dense, paged bf16 and paged int8 engines
    over one set of Llama-3-8B-width weights, `n_layers` deep (8 slots
    armed at lengths 64-2164, max_seq 4096, kv_block 128), timed in turns
    (A B C C B A): the step is host-bound, so only times taken side by
    side in one run compare. Then the program ledger's cost: the dense
    engine (ledger auto, counted on the card) against a twin over the
    same weights with the ledger off (`_ledger_cost`)."""
    import random

    from ome_tpu_torch.engine.core import InferenceEngine
    from ome_tpu_torch.models.config import llama3_8b
    from ome_tpu_torch.models.params import init_params

    cfg = llama3_8b().replace(dtype=torch.bfloat16, num_layers=n_layers)
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
    from ome_tpu_torch.perf.ledger import ProgramLedger
    off = InferenceEngine(params, cfg, max_slots=8, max_seq=4096,
                          device="cuda", seed=seed,
                          ledger=ProgramLedger(mode="off"))
    out["ledger_cost"] = _ledger_cost(
        torch, {"auto": engines["dense"], "off": off}, prompt)
    del engines, params, off
    return out


def _ledger_cost(torch, engines, prompt, steps: int = 50):
    """Median wall time of one decode step (8 slots armed at lengths
    64-2164, host read of the tokens included) of each engine, in turns
    of `steps` steps (A B B A)."""
    import numpy as np
    dev = torch.device("cuda")
    greedy = (torch.zeros(8, device=dev),
              torch.zeros(8, dtype=torch.int32, device=dev),
              torch.ones(8, device=dev))
    states = {}
    for name, eng in engines.items():
        state = eng.new_state()
        for slot in range(eng.max_slots):
            tok, kv, n, bucket = eng.prefill(prompt(64 + 300 * slot))
            state = eng.insert(state, kv, slot, n, tok, bucket)
        for _ in range(3):  # warm: the auto ledger counted its keys already
            state, toks = eng.decode(state, *greedy)
            np.asarray(toks)
        states[name] = state
    walls = {name: [] for name in engines}
    for name in list(engines) + list(engines)[::-1]:
        eng = engines[name]
        for _ in range(steps):
            t = time.perf_counter()
            states[name], toks = eng.decode(states[name], *greedy)
            np.asarray(toks)
            walls[name].append((time.perf_counter() - t) * 1e3)
    out = {name: {"median_ms": statistics.median(w), "steps": len(w)}
           for name, w in walls.items()}
    log(f"[steps] ledger cost, dense engine decode step in turns of "
        f"{steps} steps: " + ", ".join(
            f"ledger {name} median {r['median_ms']:.4f} ms over "
            f"{r['steps']} steps" for name, r in out.items()))
    return out


def _admit(eng, prompts, adapters=None):
    """A fresh decode state with each prompt prefilled into slot 0, 1,
    ... (with its LoRA adapter, from `adapters`, where not None);
    returns (state, each slot's first token as a list)."""
    state = eng.new_state()
    out = []
    for slot, ids in enumerate(prompts):
        ad = adapters[slot] if adapters else None
        kw = {} if ad is None else {"adapter": ad}
        tok, kv, n, bucket = eng.prefill(ids, **kw)
        state = eng.insert(state, kv, slot, n, tok, bucket, **kw)
        out.append([int(tok)])
    return state, out


def _greedy_streams(torch, eng, prompts, steps: int, adapters=None):
    """Greedy streams of `prompts` through the engine API (`_admit`),
    then `steps - 1` decode steps of every slot; the slots are freed
    after. Returns (streams, the top-2 logit gap of each slot at each
    decode step, the first decode step's fp32 logits of the prompts'
    slots)."""
    import numpy as np
    state, out = _admit(eng, prompts, adapters)
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
    for slot in range(len(prompts)):
        eng.free_slot(slot)
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
                      steps: int = 32, n_layers: int = CUT_LAYERS):
    """Weight-only quantization at the Llama-3-8B widths, `n_layers`
    deep, over one bf16 weight set and the port's `quantize_params` of
    it:

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
      where B4 and the mm may land one ulp (2^-7 of the value) apart
      (P = 7 x n_layers + 1 at this depth);
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

    cfg = llama3_8b().replace(dtype=torch.bfloat16, num_layers=n_layers)
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
            f"{walls} ms; device busy {busy} ms"
            + (f" (before the int4 kernel's redesign: "
               f"{INT4_STEP_DEVICE_MS_BEFORE} ms)" if name == "int4" else ""))

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


# -- phase 11: checkpoint -----------------------------------------------------


def _bits(torch, t):
    """A tensor's bits as an integer view (bit equality, -0.0 != 0.0)."""
    return t.view({2: torch.int16, 4: torch.int32,
                   1: torch.uint8}[t.element_size()])


def _ckpt_prompts(seed: int, vocab: int):
    """The two prompts phase 11 serves (phase 11b serves them again)."""
    import random
    rng = random.Random(seed + 5)
    return [[rng.randrange(3, vocab) for _ in range(n)] for n in (20, 300)]


def phase_checkpoint(torch, seed: int = 0, n_layers: int = 4):
    """A Llama-3-8B-width checkpoint (n_layers deep, bf16, HF names, two
    shards + model.safetensors.index.json) written from the port's
    seeded init under chiprun_out/ and handed on to phase 11b (`dir`;
    removed here if this phase fails): loaded back by
    `models/checkpoint.load_params` onto the card, every leaf bit-equal
    to what was written (load GB/s printed), then served with
    `--model-dir` and no `--random-weights`: its first greedy tokens
    equal those of an engine over the in-memory params."""
    import shutil

    from ome_tpu_torch.engine import serve
    from ome_tpu_torch.engine.core import InferenceEngine
    from ome_tpu_torch.engine.scheduler import Request
    from ome_tpu_torch.models import checkpoint
    from ome_tpu_torch.models.config import llama3_8b
    from ome_tpu_torch.models.params import init_params

    cfg = llama3_8b().replace(num_layers=n_layers, dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    params = init_params(cfg, gen, torch.device("cuda"))
    d = os.path.join(OUT_DIR, f"ckpt_llama3_8b_{n_layers}l")
    out = {}
    try:
        shutil.rmtree(d, ignore_errors=True)
        t0 = time.monotonic()
        tensors = checkpoint.hf_tensors(params, cfg)
        files = checkpoint.save_checkpoint(d, tensors, shards=2)
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(_hf_config(cfg), f)
        nbytes = sum(t.numel() * t.element_size() for t in tensors.values())
        out["param_count"] = sum(t.numel() for t in tensors.values())
        del tensors
        out["write_s"] = time.monotonic() - t0
        out["bytes"] = nbytes
        torch.cuda.synchronize()
        t0 = time.monotonic()
        loaded, lcfg = checkpoint.load_params(d, dtype=torch.bfloat16,
                                              device="cuda")
        torch.cuda.synchronize()
        out["load_s"] = time.monotonic() - t0
        out["load_gbps"] = nbytes / out["load_s"] / 1e9

        def leaves(tree, prefix=""):
            for k, v in tree.items():
                if isinstance(v, dict):
                    yield from leaves(v, prefix + k + ".")
                else:
                    yield prefix + k, v
        want = dict(leaves(params))
        got = dict(leaves(loaded))
        if got.keys() != want.keys():
            fail(f"checkpoint: loaded leaves {sorted(got)} != written "
                 f"{sorted(want)}")
        for name, t in want.items():
            if got[name].shape != t.shape or got[name].dtype != t.dtype \
                    or not torch.equal(_bits(torch, got[name]),
                                       _bits(torch, t)):
                fail(f"checkpoint: leaf {name} is not bit-equal to what "
                     f"was written")
        del loaded
        log(f"[checkpoint] Llama-3-8B widths, {n_layers} layers, bf16: "
            f"{nbytes / 1e9:.3f} GB in {files} + index, written in "
            f"{out['write_s']:.1f} s; load_params to the card "
            f"{out['load_s']:.2f} s ({out['load_gbps']:.2f} GB/s); all "
            f"{len(want)} leaves bit-equal")
        prompts = _ckpt_prompts(seed, cfg.vocab_size)
        steps = 8
        t0 = time.monotonic()
        server, sched, engine = serve.build_server(
            ["--model-dir", d, "--max-slots", "2", "--max-seq", "1024",
             "--port", "0", "--host", "127.0.0.1", "--seed", str(seed)])
        out["serve_startup_s"] = time.monotonic() - t0
        try:
            status, raw = _post(f"http://127.0.0.1:{server.port}",
                                {"prompt": prompts[0], "max_tokens": 4,
                                 "temperature": 0.0})
            _completion(status, raw, 4, "checkpoint completion")
            served = []
            for ids in prompts:
                req = sched.submit(Request(prompt_ids=ids,
                                           max_new_tokens=steps))
                served.append(list(req.wait_output(300)))
        finally:
            server.stop()
        del server, sched, engine
        twin = InferenceEngine(params, cfg, max_slots=2, max_seq=1024,
                               device="cuda", seed=seed)
        ref, _, _ = _greedy_streams(torch, twin, prompts, steps)
        del twin
        out["first_tokens"] = served
        if served != ref:
            fail(f"checkpoint: the served checkpoint's greedy tokens "
                 f"{served} differ from the in-memory engine's {ref}")
        log(f"[checkpoint] served with --model-dir (no --random-weights, "
            f"up in {out['serve_startup_s']:.1f} s): first {steps} greedy "
            f"tokens of {len(prompts)} prompts equal the engine's over "
            f"the in-memory params")
    except BaseException:
        shutil.rmtree(d, ignore_errors=True)
        raise
    del params
    out["dir"] = d
    return out


# -- phase 11b: the weight plane ----------------------------------------------


# each object's `weight_fetch.slow` pause in the run that is killed: the
# manifest records the first shard well before the last object
WP_SLOW_S = 0.25


def _get_json(url: str, timeout: float = 60):
    import urllib.request
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def phase_weight_plane(torch, card: str, ckpt: dict, seed: int = 0):
    """Phase 11's checkpoint (Llama-3-8B widths, 4 layers, bf16: two
    shards, the index, config.json; `ckpt["dir"]`, removed here) through
    the port's weight plane: `hfconfig.parse_model_dir` gives its family
    and the exact parameter count phase 11 wrote; the weight-plane CLI
    (`python -m ome_tpu_torch.modelagent.weightplane`, a child) fetches
    it from local:// into a target under chiprun_out/ with a
    `weight_fetch.slow` rule and is SIGKILLed once its staging manifest
    records a shard and before it records every object (the serving
    path absent), then run again: it resumes every recorded object and
    publishes, and each published object's sha256 equals the source's
    (`chaos.kill_and_resume_fetch`, the chaos harness's kill episode).
    Then `serve.build_server` serves the published tree with one LoRA
    slot of rank 16: /ready's fetch_bps equals `published_fetch_bps`
    and is above 0, and the first 8 greedy tokens of phase 11's prompts
    equal phase 11's served tokens (B1 and B2 launched). The serving
    agent stages a rank-16 PEFT adapter zip from local:// and hot-loads
    it (`POST /v1/adapters`): its greedy tokens equal an in-process twin
    engine's with the same adapter registered; taken out of the info
    file, the adapter leaves `/v1/models` (`DELETE`)."""
    import shutil
    import zipfile

    from ome_tpu_torch.agent.serving_agent import ServingAgent
    from ome_tpu_torch.chaos import kill_and_resume_fetch
    from ome_tpu_torch.engine import serve
    from ome_tpu_torch.engine.core import InferenceEngine
    from ome_tpu_torch.engine.scheduler import Request
    from ome_tpu_torch.hfconfig import parse_model_dir
    from ome_tpu_torch.modelagent import weightplane
    from ome_tpu_torch.models import checkpoint
    from ome_tpu_torch.ops import flash
    from ome_tpu_torch.storage import native_available

    src = ckpt["dir"]
    tag = "[weight plane]"
    base = os.path.join(OUT_DIR, "weight_plane")
    target = os.path.join(base, "served", "llama3_8b_4l")
    out = {"native_chunker": native_available()}
    try:
        shutil.rmtree(base, ignore_errors=True)
        os.makedirs(os.path.dirname(target))
        parsed = parse_model_dir(src)
        out["parsed"] = {"model_type": parsed.model_type,
                         "architecture": parsed.architecture,
                         "parameter_count": parsed.parameter_count,
                         "parameter_size": parsed.parameter_size,
                         "capabilities": parsed.capabilities}
        if (parsed.model_type, parsed.architecture) != (
                "llama", "LlamaForCausalLM") or \
                "TEXT_GENERATION" not in parsed.capabilities:
            fail(f"{tag}: hfconfig parsed the checkpoint as {out['parsed']}")
        if parsed.parameter_count != ckpt["param_count"]:
            fail(f"{tag}: hfconfig's exact parameter count "
                 f"{parsed.parameter_count} != the {ckpt['param_count']} "
                 "phase 11 wrote")
        log(f"{tag} hfconfig: {parsed.model_type} / {parsed.architecture}, "
            f"{parsed.parameter_count} parameters ({parsed.parameter_size}) "
            f"from the index, equal to what phase 11 wrote; native chunker "
            f"loaded: {out['native_chunker']}")

        # kill and resume (the chaos harness's contract), once a shard is
        # recorded and before every object is
        names = sorted(os.listdir(src))
        sizes = {n: os.path.getsize(os.path.join(src, n)) for n in names}
        res, violations = kill_and_resume_fetch(
            src, target, name="llama3-8b-4l", slow_s=WP_SLOW_S,
            kill_when=lambda m: any(n.endswith(".safetensors")
                                    for n in m.objects), timeout=300)
        if violations:
            fail(f"{tag}: the kill and resume broke the weight plane's "
                 f"contract: {violations}")
        recorded, stats = sorted(res["recorded"]), res["stats"]
        if not 0 < len(recorded) < len(names):
            fail(f"{tag}: the staging manifest recorded {recorded} of "
                 f"{names} at the kill")
        if stats.get("fetched") != len(names) - len(recorded):
            fail(f"{tag}: the re-run's stats {stats} do not fetch the "
                 f"{len(names) - len(recorded)} objects not recorded")
        want = res["source_sha256"]
        if sorted(want) != names:
            fail(f"{tag}: hashed {sorted(want)}, the source holds {names}")
        man = weightplane.published_manifest(target)
        if {n: r["sha256"] for n, r in man.objects.items()} != want:
            fail(f"{tag}: the published manifest's digests are not the "
                 "source's")
        fetched = sum(sizes[n] for n in names if n not in recorded)
        out.update(
            killed_after_s=res["killed_after_s"],
            rerun_wall_s=res["rerun_wall_s"], hash_s=res["hash_s"],
            objects=len(names), bytes=sum(sizes.values()),
            recorded_at_kill=recorded, resumed=stats["resumed"],
            fetched_bytes=fetched, fetch_s=stats["seconds"],
            fetch_gbps=fetched / stats["seconds"] / 1e9,
            manifest_fetch_bps=weightplane.published_fetch_bps(target))
        log(f"{tag} killed the weight-plane child {out['killed_after_s']:.2f}"
            f" s in with {recorded} recorded (serving path absent); the "
            f"re-run resumed {stats['resumed']}, fetched "
            f"{stats['fetched']} ({fetched / 1e9:.3f} GB) and published "
            f"in {out['rerun_wall_s']:.2f} s wall; all {len(names)} "
            f"published sha256 equal the source's (hashed in "
            f"{out['hash_s']:.2f} s)")
        log(f"{tag} fetch {out['fetch_gbps']:.3f} GB/s (bytes fetched by "
            f"the re-run over its fetch seconds, local:// on a warm page "
            f"cache); the manifest's fetch_bps "
            f"{out['manifest_fetch_bps'] / 1e9:.3f} GB/s counts every "
            f"object's bytes over the re-run's seconds; card {card}")

        # serve the published tree
        flash.reset_launches()
        t0 = time.monotonic()
        server, sched, engine = serve.build_server(
            ["--model-dir", target, "--lora-slots", "1", "--lora-rank",
             str(LORA_RANK), "--max-slots", "2", "--max-seq", "1024",
             "--port", "0", "--host", "127.0.0.1", "--seed", str(seed)])
        out["serve_startup_s"] = time.monotonic() - t0
        prompts = _ckpt_prompts(seed, engine.cfg.vocab_size)
        url = f"http://127.0.0.1:{server.port}"
        info = os.path.join(base, "adapters.json")
        try:
            ready = _get_json(url + "/ready")
            out["ready_fetch_bps"] = ready.get("fetch_bps")
            if ready.get("fetch_bps") != out["manifest_fetch_bps"] or \
                    not out["manifest_fetch_bps"] > 0:
                fail(f"{tag}: /ready says fetch_bps "
                     f"{ready.get('fetch_bps')}, the published manifest "
                     f"{out['manifest_fetch_bps']}")
            reqs = [sched.submit(Request(prompt_ids=ids, max_new_tokens=8))
                    for ids in prompts]
            served = [list(r.wait_output(300)) for r in reqs]
            if served != ckpt["first_tokens"]:
                fail(f"{tag}: the published tree's greedy tokens {served} "
                     f"differ from phase 11's {ckpt['first_tokens']}")
            launches = dict(flash.LAUNCHES)
            for name in ("flash_decode", "flash_prefill"):
                if launches[name] <= 0:
                    fail(f"{tag}: {name} was never launched while serving "
                         "the published tree")
            progs = engine.ledger.snapshot()
            out["ledger_dispatches"] = {
                kind: sum(e["dispatches"] for e in progs
                          if e["program"].startswith(kind))
                for kind in ("prefill", "decode")}
            out["launches"] = {n: launches[n]
                               for n in ("flash_decode", "flash_prefill")}
            log(f"{tag} served the published tree (one LoRA slot, up in "
                f"{out['serve_startup_s']:.1f} s): /ready fetch_bps "
                f"{ready['fetch_bps']:.6g} equals the manifest's; first 8 "
                f"greedy tokens of phase 11's prompts equal phase 11's; "
                f"launches B1 {launches['flash_decode']}, B2 "
                f"{launches['flash_prefill']}; the ledger's dispatches "
                f"{out['ledger_dispatches']}")

            # the serving agent: a rank-16 adapter zip from local://
            cfg = engine.cfg
            adir = _write_adapter(torch, os.path.join(base, "peft"), cfg,
                                  seed + 900, dtype=torch.bfloat16)
            store = os.path.join(base, "store")
            os.makedirs(store)
            with zipfile.ZipFile(os.path.join(store, "ft1.zip"), "w") as z:
                for fn in ("adapter_config.json",
                           "adapter_model.safetensors"):
                    z.write(os.path.join(adir, fn), fn)
            with open(info, "w") as f:
                json.dump([{"name": "ft1",
                            "storageUri": f"local://{store}"}], f)
            agent = ServingAgent(info, os.path.join(base, "adapters"),
                                 engine_url=url)
            t0 = time.monotonic()
            if not agent.sync():
                fail(f"{tag}: the serving agent staged nothing")
            out["adapter_stage_and_load_s"] = time.monotonic() - t0
            ids = [m["id"] for m in _get_json(url + "/v1/models")["data"]]
            if "ft1" not in ids:
                fail(f"{tag}: /v1/models lists {ids} after the agent's "
                     "hot-load")
            reqs = [sched.submit(Request(prompt_ids=p, max_new_tokens=8,
                                         adapter="ft1")) for p in prompts]
            adapted = [list(r.wait_output(300)) for r in reqs]
            with open(info, "w") as f:
                json.dump([], f)
            if not agent.sync():
                fail(f"{tag}: the serving agent did not unload ft1")
            ids = [m["id"] for m in _get_json(url + "/v1/models")["data"]]
            if "ft1" in ids:
                fail(f"{tag}: /v1/models still lists ft1 after the agent "
                     "unloaded it")
        finally:
            server.stop()
        del server, sched, engine
        params, lcfg = checkpoint.load_params(target, dtype=torch.bfloat16,
                                              device="cuda")
        twin = InferenceEngine(params, lcfg, max_slots=2, max_seq=1024,
                               device="cuda", seed=seed, lora_slots=1,
                               lora_rank=LORA_RANK)
        twin.register_adapter("ft1", adir)
        ref, _, _ = _greedy_streams(torch, twin, prompts, 8,
                                    adapters=["ft1", "ft1"])
        del twin, params
        if adapted != ref:
            fail(f"{tag}: the hot-loaded adapter's greedy tokens {adapted} "
                 f"differ from the twin engine's {ref}")
        out["adapter_tokens_differ_from_base"] = adapted != served
        log(f"{tag} serving agent: staged ft1.zip from local:// and "
            f"hot-loaded it in {out['adapter_stage_and_load_s']:.2f} s; its "
            f"greedy tokens equal the twin engine's (differ from the base "
            f"model's: {out['adapter_tokens_differ_from_base']}); taken out "
            f"of the info file, it left /v1/models")
    finally:
        shutil.rmtree(base, ignore_errors=True)
        shutil.rmtree(src, ignore_errors=True)
    return out


# -- phase 12: step-plan identity ---------------------------------------------


# embedding scale of phase 12's tied random weights: at 4x the greedy
# streams repeat enough n-grams for the drafter to be accepted, which
# phase 12 checks on every run
EMBED_SCALE = 4.0


def _echo_prompts(bases, continuations):
    """Prompts that repeat n-grams: base + its own greedy continuation +
    base again. The drafter matches the tail n-gram (the base's end)
    and proposes the continuation that followed it; where the model's
    next tokens depend mostly on the last ones (random weights do), the
    verify accepts them."""
    return [list(b) + list(c) + list(b)
            for b, c in zip(bases, continuations)]


def _multi_streams(torch, eng, prompts, steps: int, k: int,
                   adapters=None):
    """Greedy streams of `prompts` (`_admit`) through `decode_multi`
    chunks of `k` (the first token from prefill, then `steps - 1`
    more), paged chunks committed after each drain; the slots are freed
    after."""
    import numpy as np
    n = eng.max_slots
    state, out = _admit(eng, prompts, adapters)
    greedy = (np.zeros(n, np.float32), np.zeros(n, np.int32),
              np.ones(n, np.float32))
    stops = np.full((n, 4), -1, np.int32)
    while min(len(s) for s in out) < steps:
        budget = np.zeros(n, np.int32)
        for slot, s in enumerate(out):
            budget[slot] = min(steps - len(s), k)
        state, toks, adv = eng.decode_multi(state, *greedy, steps=k,
                                            budget=budget, stop_ids=stops)
        toks, adv = np.asarray(toks), np.asarray(adv)
        for slot in range(len(prompts)):
            out[slot] += [int(t) for t in toks[slot, :int(adv[slot])]]
            eng.commit_spec(slot, int(adv[slot]))
    for slot in range(len(prompts)):
        eng.free_slot(slot)
    return out


def _sched_streams(eng, prompts, steps: int, adapters=None, **kw):
    """Greedy streams through the port's Scheduler (each request with
    its LoRA adapter from `adapters`, where given), stepped in this
    thread; returns (streams, scheduler)."""
    from ome_tpu_torch.engine.scheduler import Request, Scheduler
    sched = Scheduler(eng, **kw)
    reqs = [sched.submit(Request(
        prompt_ids=ids, max_new_tokens=steps,
        adapter=adapters[i] if adapters else None))
        for i, ids in enumerate(prompts)]
    for _ in range(20 * steps):
        if all(r.done.is_set() for r in reqs):
            break
        sched.step()
    else:
        fail("step plans: the scheduler did not finish its requests")
    return [list(r.output_ids) for r in reqs], sched


def phase_step_plans(torch, seed: int = 0, n_layers: int = 4,
                     steps: int = 40):
    """fp32 at the Llama-3-8B widths, `n_layers` deep, through a dense
    cache and an fp32 paged pool (kv_block 128): single decode steps,
    `decode_multi` in chunks of 4, and the Scheduler at spec_tokens 4,
    steps_per_dispatch 4, pipeline depth 1 give identical greedy
    streams; drafts are accepted; B1 and B2 launch on the dense cache,
    B2 at Sq 5 (the verify forward), B3 on the pool; the pool is
    conserved.

    The weights are the seeded init with the embeddings tied and the
    table scaled by `EMBED_SCALE`: the greedy streams then run in
    repeats of a token, broken by context, which the n-gram drafter
    predicts in part (drafts accepted and rejected). With the untied
    init at vocabulary 128256 the greedy streams repeat no n-gram in 40
    tokens, so no draft is ever proposed."""
    import random

    from ome_tpu_torch.engine.core import InferenceEngine
    from ome_tpu_torch.models.config import llama3_8b
    from ome_tpu_torch.models.params import init_params
    from ome_tpu_torch.ops import flash

    cfg = llama3_8b().replace(num_layers=n_layers, dtype=torch.float32,
                              tie_word_embeddings=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    params = init_params(cfg, gen, torch.device("cuda"))
    params["embed"].mul_(EMBED_SCALE)
    rng = random.Random(seed + 3)
    prompts = [[rng.randrange(3, cfg.vocab_size) for _ in range(n)]
               for n in (20, 75, 150, 300)]
    # the query rows of every prefill-kernel launch, read in passing
    sq_seen = []
    prefill = flash.flash_prefill

    def recording_prefill(q, *a, **kw):
        sq_seen.append(int(q.shape[1]))
        return prefill(q, *a, **kw)
    flash.flash_prefill = recording_prefill
    out, streams = {}, {}
    try:
        for name, kw in (("dense", {}), ("paged", {"kv_block": 128})):
            eng = InferenceEngine(params, cfg, max_slots=4, max_seq=2048,
                                  device="cuda", seed=seed, **kw)
            flash.reset_launches()
            del sq_seen[:]
            t0 = time.monotonic()
            single, gaps, _ = _greedy_streams(torch, eng, prompts, steps)
            multi = _multi_streams(torch, eng, prompts, steps, k=4)
            planned, sched = _sched_streams(
                eng, prompts, steps, pipeline_depth=1, spec_tokens=4,
                steps_per_dispatch=4)
            torch.cuda.synchronize()
            launches = dict(flash.LAUNCHES)
            st = sched.stats
            ok, _ = eng.kv_conservation()
            free = eng.kv_pool_stats["kv_blocks_free"]
            res = {"secs": time.monotonic() - t0, "launches": launches,
                   "verify_sq": sorted(set(sq_seen) & {5}),
                   "spec_steps": st["spec_steps_total"],
                   "spec_proposed": st["spec_proposed_tokens_total"],
                   "spec_accepted": st["spec_accepted_tokens_total"],
                   "chunks": sched._ph_device_loop.count,
                   "decode_steps": st["decode_steps_total"],
                   "min_top2_gap": min(float(g[:len(prompts)].min())
                                       for g in gaps),
                   "kv_conservation": ok}
            out[name] = res
            streams[name] = (single, multi, planned)
            for what, got in (("decode_multi K=4", multi),
                              ("scheduler spec 4 K 4", planned)):
                if got != single:
                    slot = next(i for i, (a, b) in
                                enumerate(zip(single, got)) if a != b)
                    fail(f"step plans {name}: {what} stream of prompt "
                         f"{slot} differs from single steps: {got[slot]} "
                         f"vs {single[slot]}")
            if res["spec_accepted"] <= 0:
                fail(f"step plans {name}: no draft was accepted "
                     f"({res['spec_proposed']} proposed)")
            if name == "dense":
                if launches["flash_decode"] <= 0 or 5 not in sq_seen:
                    fail(f"step plans dense: B1 or B2 at Sq 5 did not "
                         f"run ({launches}, prefill Sq {set(sq_seen)})")
            elif launches["flash_paged_decode"] <= 0 or \
                    free != eng.kv_blocks - 1 or not ok:
                fail(f"step plans paged: B3 launches "
                     f"{launches['flash_paged_decode']}, pool conserved "
                     f"{ok}, free {free} of {eng.kv_blocks}")
            log(f"[step plans] fp32 {name}, Llama-3-8B widths, {n_layers} "
                f"layers: single steps, decode_multi K=4 and the "
                f"scheduler (spec 4, K 4, depth 1) give identical "
                f"{steps}-token streams for {len(prompts)} prompts "
                f"(smallest top-2 gap {res['min_top2_gap']:.3e}); spec "
                f"steps {res['spec_steps']}, proposed "
                f"{res['spec_proposed']}, accepted {res['spec_accepted']}; "
                f"chunks {res['chunks']}; launches {launches}; prefill Sq "
                f"seen {sorted(set(sq_seen))}; pool conserved {ok}; "
                f"{res['secs']:.1f} s")
            del eng, sched
        if streams["dense"][0] != streams["paged"][0]:
            fail("step plans: dense and paged fp32 streams differ")
    finally:
        flash.flash_prefill = prefill
    del params
    return out


# -- phases 17 and 19: the other families in fp32 -----------------------------


def phase_qk_norm_identity(torch, seed: int = 0, n_layers: int = 4,
                           steps: int = 32):
    """Qwen3-8B widths (per-head q/k RMSNorm), `n_layers` deep, fp32,
    through the engine API: the dense engine (B1) and the paged engine
    over fp32 pools (B3) give identical greedy streams for 4 prompts.
    The init's unit q/k norm scales are replaced by seeded 1 + N(0, 0.3)
    values, so that a missing or misplaced norm shows."""
    import random

    from ome_tpu_torch.engine.core import InferenceEngine
    from ome_tpu_torch.models.config import ModelConfig
    from ome_tpu_torch.models.params import init_params
    from ome_tpu_torch.ops import flash

    cfg = ModelConfig.from_hf_config(QWEN3_8B).replace(
        num_layers=n_layers, dtype=torch.float32)
    if not cfg.qk_norm:
        fail("qk_norm identity: the Qwen3-8B config has no qk_norm")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    params = init_params(cfg, gen, torch.device("cuda"))
    for name in ("q_norm", "k_norm"):
        t = params["layers"][name]
        t.add_(torch.randn(t.shape, generator=gen, device=t.device)
               .mul_(0.3))
    rng = random.Random(seed + 4)
    prompts = [[rng.randrange(3, cfg.vocab_size) for _ in range(n)]
               for n in (37, 200, 515, 1000)]
    streams, gaps = {}, {}
    flash.reset_launches()
    for name, kw in (("dense", {}), ("paged", {"kv_block": 128})):
        eng = InferenceEngine(params, cfg, max_slots=4, max_seq=2048,
                              device="cuda", seed=seed, **kw)
        streams[name], gaps[name], _ = _greedy_streams(torch, eng, prompts,
                                                       steps)
        del eng
    launches = dict(flash.LAUNCHES)
    if launches["flash_decode"] <= 0 or launches["flash_paged_decode"] <= 0:
        fail(f"qk_norm identity: a decode kernel did not run ({launches})")
    for slot in range(len(prompts)):
        a, b = streams["dense"][slot], streams["paged"][slot]
        if a != b:
            step = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
            fail(f"qk_norm identity: prompt {slot} differs at step {step} "
                 f"(dense {a[step]}, paged {b[step]})")
    min_gap = min(float(g[:len(prompts)].min()) for g in gaps["dense"])
    log(f"[qwen3] fp32, Qwen3-8B widths (qk_norm, G 4), {n_layers} layers: "
        f"dense (flash_decode) and paged fp32 pool (flash_paged_decode) "
        f"give identical {steps}-token greedy streams for {len(prompts)} "
        f"prompts (smallest top-2 logit gap {min_gap:.3e}); launches "
        f"{launches}")
    del params
    return {"streams_identical": True, "steps": steps,
            "prompts": len(prompts), "min_top2_gap": min_gap,
            "launches": launches}


def phase_moe_identity(torch, seed: int = 0, n_layers: int = 4,
                       steps: int = 24):
    """Mixtral-8x7B widths, `n_layers` deep, fp32, dense cache, through
    the engine API: the ragged dispatch (single steps, `decode_multi`
    K=4, and the Scheduler at spec_tokens 4 / steps_per_dispatch 4) and
    the dense impl give identical greedy streams; the n-gram drafter
    proposes, so the verify forward (B2 at Sq 5, through the MoE block)
    runs. As in phase 12, the embeddings are tied and scaled by
    `EMBED_SCALE`, so that the random model's greedy streams repeat
    tokens for the drafter to match (untied, they repeat none)."""
    import random

    from ome_tpu_torch.engine.core import InferenceEngine
    from ome_tpu_torch.models.config import ModelConfig
    from ome_tpu_torch.models.params import init_params
    from ome_tpu_torch.ops import flash

    cfg = ModelConfig.from_hf_config(MIXTRAL_8X7B).replace(
        num_layers=n_layers, dtype=torch.float32, moe_impl="ragged",
        tie_word_embeddings=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    params = init_params(cfg, gen, torch.device("cuda"))
    params["embed"].mul_(EMBED_SCALE)
    rng = random.Random(seed + 5)
    prompts = [[rng.randrange(3, cfg.vocab_size) for _ in range(n)]
               for n in (20, 75, 150, 300)]
    sq_seen = []
    prefill = flash.flash_prefill

    def recording_prefill(q, *a, **kw):
        sq_seen.append(int(q.shape[1]))
        return prefill(q, *a, **kw)
    flash.flash_prefill = recording_prefill
    flash.reset_launches()
    t0 = time.monotonic()
    try:
        eng = InferenceEngine(params, cfg, max_slots=4, max_seq=1024,
                              device="cuda", seed=seed)
        single, gaps, _ = _greedy_streams(torch, eng, prompts, steps)
        multi = _multi_streams(torch, eng, prompts, steps, k=4)
        planned, sched = _sched_streams(eng, prompts, steps,
                                        pipeline_depth=1, spec_tokens=4,
                                        steps_per_dispatch=4)
        st = dict(sched.stats)
        del eng, sched
        eng = InferenceEngine(params, cfg.replace(moe_impl="dense"),
                              max_slots=4, max_seq=1024, device="cuda",
                              seed=seed)
        dense, _, _ = _greedy_streams(torch, eng, prompts, steps)
        del eng
        torch.cuda.synchronize()
    finally:
        flash.flash_prefill = prefill
    launches = dict(flash.LAUNCHES)
    for what, got in (("dense impl", dense), ("decode_multi K=4", multi),
                      ("scheduler spec 4 K 4", planned)):
        if got != single:
            slot = next(i for i, (a, b) in enumerate(zip(single, got))
                        if a != b)
            fail(f"moe identity: the {what} stream of prompt {slot} "
                 f"differs from the ragged single steps: {got[slot]} vs "
                 f"{single[slot]}")
    if st["spec_proposed_tokens_total"] <= 0 or 5 not in sq_seen:
        fail(f"moe identity: the verify forward did not run (proposed "
             f"{st['spec_proposed_tokens_total']}, prefill Sq "
             f"{sorted(set(sq_seen))})")
    min_gap = min(float(g[:len(prompts)].min()) for g in gaps)
    res = {"streams_identical": True, "steps": steps,
           "prompts": len(prompts), "min_top2_gap": min_gap,
           "spec_steps": st["spec_steps_total"],
           "spec_proposed": st["spec_proposed_tokens_total"],
           "spec_accepted": st["spec_accepted_tokens_total"],
           "launches": launches, "secs": time.monotonic() - t0}
    log(f"[mixtral] fp32, Mixtral-8x7B widths, {n_layers} layers: ragged "
        f"single steps, ragged decode_multi K=4, the ragged scheduler "
        f"(spec 4, K 4) and the dense impl give identical {steps}-token "
        f"streams for {len(prompts)} prompts (smallest top-2 gap "
        f"{min_gap:.3e}); spec steps {res['spec_steps']}, proposed "
        f"{res['spec_proposed']}, accepted {res['spec_accepted']}; "
        f"launches {launches}; {res['secs']:.1f} s")
    del params
    return res


# -- phase 13/14: step-plan servers -------------------------------------------


SERVE_SCHEMA = {"type": "object",
                "properties": {"name": {"type": "string",
                                        "pattern": "^[a-z]{1,12}$"},
                               "count": {"type": "integer", "minimum": 0,
                                         "maximum": 999},
                               "ok": {"type": "boolean"}},
                "required": ["name", "count", "ok"],
                "additionalProperties": False}


def phase_serve_stepplan(torch, paged: bool, seed: int = 0, before=None):
    """The bf16 Llama-3-8B-width server (`CUT_LAYERS` deep) with
    `--spec-tokens 4 --steps-per-dispatch 4`, dense (`--max-slots 8`) or paged
    (`--kv-block 128 --max-slots 16 --kv-blocks 129`): concurrent
    completions of prompts that repeat n-grams, a `json_schema` request
    whose output must parse against its schema and, paged, a burst
    larger than the pool with the pool conserved at idle. Spec
    proposed/accepted, chunks, launches and TPOT are printed beside
    `before` (phase 4's or 5's run) for the record."""
    import concurrent.futures
    import random
    import tempfile

    from ome_tpu_torch.engine import serve
    from ome_tpu_torch.models.config import llama3_8b
    from ome_tpu_torch.ops import flash

    cfg = llama3_8b().replace(num_layers=CUT_LAYERS)
    rng = random.Random(seed + 7)
    tag = "[serve spec paged]" if paged else "[serve spec]"
    out = {"paged": paged}
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "config.json"), "w") as f:
            json.dump(_hf_config(cfg), f)
        reqlog = os.path.join(tmp, "requests.jsonl")
        argv = ["--model-dir", tmp, "--random-weights", "--seed", str(seed),
                "--max-seq", "4096", "--port", "0", "--host", "127.0.0.1",
                "--request-log", reqlog, "--spec-tokens", "4",
                "--steps-per-dispatch", "4"]
        argv += (["--max-slots", "16", "--kv-block", "128", "--kv-blocks",
                  "129"] if paged else ["--max-slots", "8"])
        t0 = time.monotonic()
        server, sched, engine = serve.build_server(argv)
        torch.cuda.synchronize()
        out["startup_s"] = time.monotonic() - t0
        url = f"http://127.0.0.1:{server.port}"

        def post_all(bodies, what):
            with concurrent.futures.ThreadPoolExecutor(len(bodies)) as ex:
                futs = [ex.submit(_post, url, b) for b in bodies]
                return [_completion(*fut.result(), b["max_tokens"],
                                    f"{what} {i}")
                        for i, (fut, b) in enumerate(zip(futs, bodies))]
        seen = []
        submit = sched.submit

        def recording_submit(req):
            # keyed by the prompt as sent: a preempted request's
            # prompt_ids later take its generated tokens in
            seen.append((tuple(req.prompt_ids), req))
            return submit(req)
        sched.submit = recording_submit
        try:
            flash.reset_launches()
            lengths = ([20, 90, 175, 280, 400, 535, 690, 1200, 50, 130,
                        225, 340, 465, 610, 780, 8] if paged
                       else [8, 50, 200, 400, 750, 1100, 1300, 1500])
            # each base prompt's own greedy continuation, read from the
            # server, then base + continuation + base: prompts that
            # repeat n-grams
            bases = [[rng.randrange(3, cfg.vocab_size) for _ in range(n)]
                     for n in lengths]
            post_all([{"prompt": b, "max_tokens": 12, "temperature": 0.0}
                      for b in bases], "base request")
            conts = {key: r.output_ids for key, r in seen}
            bodies = [{"prompt": p, "max_tokens": 32, "temperature": 0.0}
                      for p in _echo_prompts(
                          bases, [conts[tuple(b)] for b in bases])]
            t_batch = time.monotonic()
            docs = post_all(bodies, "request")
            out["batch_s"] = time.monotonic() - t_batch
            out["batch_completion_tokens"] = sum(
                d["usage"]["completion_tokens"] for d in docs)
            status, raw = _post(url, {
                "prompt": "Describe the item as JSON:", "max_tokens": 64,
                "temperature": 0.0, "response_format": {
                    "type": "json_schema",
                    "json_schema": {"name": "item",
                                    "schema": SERVE_SCHEMA}}})
            if status != 200:
                fail(f"{tag} json_schema request: HTTP {status}")
            text = json.loads(raw)["choices"][0]["text"]
            try:
                doc = json.loads(text)
            except ValueError:
                fail(f"{tag} json_schema output does not parse: {text!r}")
            if set(doc) != {"name", "count", "ok"} or \
                    not 0 <= doc["count"] <= 999:
                fail(f"{tag} json_schema output breaks its schema: {doc}")
            out["json_schema_output"] = doc
            if paged:
                burst = [{"prompt": [rng.randrange(3, cfg.vocab_size)
                                     for _ in range(2040)],
                          "max_tokens": 32, "temperature": 0.0}
                         for _ in range(12)]
                t_burst = time.monotonic()
                post_all(burst, "burst request")
                out["burst_s"] = time.monotonic() - t_burst
            _wait_idle(sched)
            torch.cuda.synchronize()
            launches = dict(flash.LAUNCHES)
            st = dict(sched.stats)
            out["chunks"] = sched._ph_device_loop.count
            out["dispatches"] = (sched._ph_dispatch.count
                                 + sched._ph_device_loop.count)
            out["degradations"] = sched.degradations
            if paged:
                ok, owned = engine.kv_conservation()
                free = engine.kv_pool_stats["kv_blocks_free"]
                out.update(kv_conservation=ok, kv_blocks_free=free)
        finally:
            server.stop()
        with open(reqlog) as f:
            recs = [json.loads(line) for line in f]
    out["launches"] = launches
    for key in ("spec_steps_total", "spec_proposed_tokens_total",
                "spec_accepted_tokens_total", "decode_steps_total",
                "preemptions_total", "tokens_generated_total"):
        out[key] = st[key]
    tpot = sorted(r["tpot_s"] for r in recs if r.get("tpot_s"))
    ttft = sorted(r["ttft_s"] for r in recs if r.get("ttft_s") is not None)
    out["tpot_median_s"] = statistics.median(tpot)
    out["ttft_median_s"] = statistics.median(ttft)
    if out["spec_steps_total"] + out["chunks"] <= 0:
        fail(f"{tag}: neither a verify step nor a chunk ran")
    need = ["flash_prefill"] + (["flash_paged_decode"] if paged
                                else ["flash_decode"])
    for name in need:
        if launches[name] <= 0:
            fail(f"{tag}: kernel {name} was never launched while serving")
    if paged:
        if launches["flash_decode"]:
            fail(f"{tag}: the dense decode kernel launched during paged "
                 f"serving")
        if not out["kv_conservation"] or \
                out["kv_blocks_free"] != engine.kv_blocks - 1:
            fail(f"{tag}: the pool is not conserved at idle "
                 f"({out['kv_conservation']}, free "
                 f"{out['kv_blocks_free']} of {engine.kv_blocks})")
    prop = out["spec_proposed_tokens_total"]
    acc = out["spec_accepted_tokens_total"]
    prev = (f"{before['tpot_median_s'] * 1e3:.2f} ms at "
            f"{before['layers']} layers"
            if before and before.get("tpot_median_s") else "not measured")
    log(f"{tag} Llama-3-8B widths, {cfg.num_layers} layers, bf16, "
        f"--spec-tokens 4 "
        f"--steps-per-dispatch 4: up in {out['startup_s']:.1f} s; "
        f"{len(bodies)} concurrent completions, "
        f"{out['batch_completion_tokens']} tokens in {out['batch_s']:.2f} "
        f"s; json_schema output parses: {out['json_schema_output']}"
        + (f"; burst of 12 x 2040 tokens in {out['burst_s']:.2f} s, pool "
           f"conserved at idle (preemptions {out['preemptions_total']})"
           if paged else ""))
    out["accept_rate"] = acc / prop if prop else None
    out["accepted_per_verify"] = acc / max(out["spec_steps_total"], 1)
    out["tokens_per_dispatch"] = (out["tokens_generated_total"]
                                  / max(out["dispatches"], 1))
    log(f"{tag} spec steps {out['spec_steps_total']}, proposed {prop}, "
        f"accepted {acc} (accept rate {out['accept_rate']}, accepted per "
        f"verify step {out['accepted_per_verify']:.3f}); chunks "
        f"{out['chunks']}; engine dispatches {out['dispatches']}, decode "
        f"tokens {out['tokens_generated_total']} "
        f"({out['tokens_per_dispatch']:.2f} per dispatch); degradations "
        f"{out['degradations']}; launches {launches}; TPOT median "
        f"{out['tpot_median_s'] * 1e3:.2f} ms (without the step flags, "
        f"phase {'5' if paged else '4'}: {prev}); TTFT median "
        f"{out['ttft_median_s'] * 1e3:.1f} ms")
    return out


# -- head_dim 96 and 256 ------------------------------------------------------


def phase_headdim_kernels(torch):
    """B1, B2, B3 and B5 at head_dim 96 (Phi-3-mini: H 32, K 32) and
    256 (Gemma-2-9B: H 16, K 8), each against its plain version with
    its existing tolerance: B1 in bf16 and fp32 at the 8B lengths and
    with window + softcap; B2 causal 2048 and window + softcap in bf16,
    a suffix chunk in fp32; B3 over bf16, fp32 and int8 pools, at D 96
    first as the Phi-3-mini paged server calls it (64-row blocks, window
    2047, so lo > 0 and off the tile grid); B5. At D 96, B1 and B3 (bf16
    and int8 pools) repeat their bits and give a sequence alone the bits
    it has in the batch."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    timer = Timer(torch, torch.device("cuda"))
    lengths = [0, 1, 17, 128, 300, 1023, 2049, 4095]
    plens = [1, 17, 128, 300, 1023, 2049, 4095, 4096]
    # lengths around and past Phi-3-mini's 2047-row window: lo = 0, 0,
    # 1, 53, 483, 954, 1953, 2049
    wlens = [5, 2047, 2048, 2100, 2530, 3001, 4000, 4096]
    cases = {"flash_decode": [], "flash_prefill": [],
             "flash_paged_decode": [], "flash_decode_quantized": []}
    for H, K, D in HEAD_DIM_SHAPES:
        bits = D == 96
        kw = {"H": H, "K": K, "D": D}
        cases["flash_decode"] += [
            decode_case(torch, timer, gen, "bf16", lengths, check_bits=bits,
                        **kw),
            decode_case(torch, timer, gen, "fp32", lengths, **kw),
            decode_case(torch, timer, gen, "bf16", lengths, window=256,
                        softcap=30.0, **kw)]
        cases["flash_prefill"] += [
            prefill_case(torch, timer, gen, "bf16", 2048, 2048, 0, **kw),
            prefill_case(torch, timer, gen, "bf16", 2048, 2048, 0,
                         window=512, softcap=50.0, **kw),
            prefill_case(torch, timer, gen, "fp32", 512, 2048, 1024, **kw)]
        if D == 96:
            # the Phi-3-mini paged server's shape: 64-row blocks and its
            # 2047-row window, whose first rows (lo) fall inside tiles;
            # NaN outside the windows shows that no row before lo counts
            cases["flash_paged_decode"] += [
                paged_case(torch, timer, gen, pool, wlens, bs=64, M=64,
                           N=8 * 64 + 1, window=2047, nan_outside=True,
                           check_bits=pool != "fp32", **kw)
                for pool in ("bf16", "fp32", "int8")]
        cases["flash_paged_decode"] += [
            paged_case(torch, timer, gen, pool, plens,
                       check_bits=bits and pool != "fp32", **kw)
            for pool in ("bf16", "fp32", "int8")]
        cases["flash_decode_quantized"].append(
            quantized_case(torch, timer, gen, lengths, **kw))
    for name, rows in cases.items():
        for c in rows:
            lib = c["library_ms"]
            log(f"[head_dim] {name}: {c['case']}: ms {c['ms']:.4f}, bound "
                f"{c['bound_ms']:.4f} ms ({c['bound_by']}), share "
                f"{c['bound_ms'] / c['ms']:.3f}, plain {c['plain_ms']:.4f} "
                f"ms, masked SDPA "
                f"{'null' if lib is None else f'{lib:.4f} ms'}"
                + ("" if c.get("same_bits") is None else
                   f"; two launches bitwise equal {c['same_bits']}; "
                   f"alone = in batch {c['batch_invariant']}"))
    return check_cases(cases)


def phase_phi3_identity(torch, seed: int = 0, n_layers: int = 4,
                        steps: int = 32):
    """Phi-3-mini widths (`PHI3_MINI_4K`: D 96, G 1, window 2047),
    `n_layers` deep, fp32, through the engine API: the dense engine (B1)
    and the paged engine over fp32 pools of 64-row blocks (B3, the
    window's first row as its lo) give identical greedy streams for 4
    prompts, two of them longer than the window."""
    import random

    from ome_tpu_torch.engine.core import InferenceEngine
    from ome_tpu_torch.models.config import ModelConfig
    from ome_tpu_torch.models.params import init_params
    from ome_tpu_torch.ops import flash

    cfg = ModelConfig.from_hf_config(PHI3_MINI_4K).replace(
        num_layers=n_layers, dtype=torch.float32)
    if cfg.head_dim != 96 or cfg.sliding_window != 2047:
        fail(f"phi3 identity: head_dim {cfg.head_dim}, window "
             f"{cfg.sliding_window}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    params = init_params(cfg, gen, torch.device("cuda"))
    rng = random.Random(seed + 8)
    prompts = [[rng.randrange(3, cfg.vocab_size) for _ in range(n)]
               for n in (37, 700, 2100, 2500)]
    streams, gaps = {}, {}
    flash.reset_launches()
    for name, kw in (("dense", {}), ("paged", {"kv_block": 64})):
        eng = InferenceEngine(params, cfg, max_slots=4, max_seq=4096,
                              device="cuda", seed=seed, **kw)
        streams[name], gaps[name], _ = _greedy_streams(torch, eng, prompts,
                                                       steps)
        del eng
    launches = dict(flash.LAUNCHES)
    for name in ("flash_decode", "flash_paged_decode", "flash_prefill"):
        if launches[name] <= 0:
            fail(f"phi3 identity: {name} did not run ({launches})")
    for slot in range(len(prompts)):
        a, b = streams["dense"][slot], streams["paged"][slot]
        if a != b:
            step = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
            fail(f"phi3 identity: prompt {slot} differs at step {step} "
                 f"(dense {a[step]}, paged {b[step]})")
    min_gap = min(float(g[:len(prompts)].min()) for g in gaps["dense"])
    log(f"[phi3] fp32, Phi-3-mini widths (D 96, G 1, window 2047), "
        f"{n_layers} layers: dense (flash_decode) and paged fp32 pool of "
        f"64-row blocks (flash_paged_decode) give identical {steps}-token "
        f"greedy streams for prompts of {[len(p) for p in prompts]} tokens "
        f"(smallest top-2 logit gap {min_gap:.3e}); launches {launches}")
    del params
    return {"streams_identical": True, "min_top2_gap": min_gap,
            "launches": launches}


def _journal_run(torch, tmp, hf, dtype, prompts, max_tokens, tag):
    """A prompt, greedy, through three servers built by
    `serve.build_server` over the same model (random weights from seed
    0): an uninterrupted one; one with `--journal` whose scheduler dies
    halfway through that stream (`engine_step.raise@N`, `--max-restarts
    0`); and a fresh one over the same journal directory, which resumes
    the request before it serves. The prompt is the first of `prompts`
    whose uninterrupted stream runs 8 tokens or more before a stop id
    (random weights may pick the tokenizer's eos). Returns the
    uninterrupted stream, the journal's whole stream, the tokens before
    the kill, the launches of the resume, the journal's bytes and
    appends, and the seconds of `resume_from_journal` and of the
    resumed request."""
    from ome_tpu_torch import faults
    from ome_tpu_torch.engine import serve
    from ome_tpu_torch.engine.journal import FILENAME
    from ome_tpu_torch.engine.scheduler import Scheduler
    from ome_tpu_torch.ops import flash

    model = os.path.join(tmp, "model")
    os.makedirs(model, exist_ok=True)
    with open(os.path.join(model, "config.json"), "w") as f:
        json.dump(hf, f)
    jdir = os.path.join(tmp, "journal")
    base = ["--model-dir", model, "--random-weights", "--seed", "0",
            "--dtype", dtype, "--max-slots", "4", "--max-seq", "4096",
            "--port", "0", "--host", "127.0.0.1"]
    body = {"max_tokens": max_tokens, "temperature": 0.0}

    def serve_one(argv, expect_fault=False):
        server, sched, _ = serve.build_server(argv)
        seen = []
        submit = sched.submit
        sched.submit = lambda r: (seen.append(r), submit(r))[1]
        try:
            try:
                _post(f"http://127.0.0.1:{server.port}", body)
            except Exception as e:  # noqa: BLE001 — the killed server
                if not expect_fault:
                    raise
                log(f"{tag} the killed server answered {type(e).__name__}")
            if expect_fault:
                t0 = time.monotonic()
                while sched.status != "dead":
                    if time.monotonic() - t0 > 60:
                        fail(f"{tag} the scheduler did not die")
                    time.sleep(0.01)
            torch.cuda.synchronize()
        finally:
            server.stop()
            if sched.journal is not None:
                sched.journal.close()
        return seen[0], (sched.journal.appends if sched.journal else 0)

    for prompt in prompts:
        body["prompt"] = prompt
        want, _ = serve_one(base)
        if len(want.output_ids) >= 8:
            break
    else:
        fail(f"{tag} every prompt's stream stopped before 8 tokens")
    # the n - 1 decode steps of an n-token stream fire engine_step; the
    # fault at the (n // 2)-th leaves about half the stream to resume
    kill_at = len(want.output_ids) // 2
    try:
        killed, appends = serve_one(
            base + ["--journal", jdir, "--journal-fsync", "always",
                    "--max-restarts", "0", "--faults",
                    f"engine_step.raise@{kill_at}"], expect_fault=True)
    finally:
        faults.reset()
    if killed.finish_reason != "engine_fault":
        fail(f"{tag} the killed request finished {killed.finish_reason}")
    before = list(killed.output_ids)
    if not 0 < len(before) < len(want.output_ids):
        fail(f"{tag} the kill came after {len(before)} tokens")
    resume_s = []
    resume = Scheduler.resume_from_journal

    def timed(self):
        t = time.perf_counter()
        n = resume(self)
        resume_s.append(time.perf_counter() - t)
        return n
    Scheduler.resume_from_journal = timed
    flash.reset_launches()
    t0 = time.monotonic()
    try:
        server, sched, _ = serve.build_server(base + ["--journal", jdir])
    finally:
        Scheduler.resume_from_journal = resume
    try:
        if sched.journal.replayed != 1:
            fail(f"{tag} the new server resumed "
                 f"{sched.journal.replayed} requests")
        # done when its tombstone is written (the scheduler's drain_idle
        # can read idle while the admission thread holds a request it
        # has taken from the queue and not yet counted, as in the
        # reference)
        while sched.journal.replay():
            if time.monotonic() - t0 > 120:
                fail(f"{tag} the resumed request did not finish")
            time.sleep(0.01)
        torch.cuda.synchronize()
        done_s = time.monotonic() - t0
        launches = dict(flash.LAUNCHES)
        appends += sched.journal.appends
    finally:
        server.stop()
        sched.journal.close()
    path = os.path.join(jdir, FILENAME)
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    got = sum((r["toks"] for r in recs if r["t"] == "prog"), [])
    if recs[-1].get("t") != "fin" or got[:len(before)] != before:
        fail(f"{tag} the journal does not hold the stream: {recs[-3:]}")
    for name in ("flash_prefill", "flash_decode"):
        if launches[name] <= 0:
            fail(f"{tag} the resume launched no {name}: {launches}")
    return {"want": list(want.output_ids), "got": got, "before": before,
            "launches": launches, "journal_bytes": os.path.getsize(path),
            "appends": appends, "records": len(recs),
            "resume_s": resume_s[0], "resumed_request_s": done_s}


def phase_journal(torch, seed: int = 0):
    """Durable requests on the card: the 4-layer fp32 Phi-3-width server
    (D 96, so B1 and B2 at head_dim 96 carry it) killed mid-decode
    and resumed by a fresh server over the same `--journal` directory
    gives a greedy stream byte-identical to an uninterrupted server's;
    then the full-size bf16 Phi-3-mini server, whose resumed stream is
    reported with its first token that differs from the uninterrupted
    one (the resume re-prefills through B2 the tokens B1 decoded, so
    bf16 rounding may differ there; identity is required in fp32 only).
    A prompt of 2100 tokens, past the 2047-token window."""
    import random
    import tempfile

    rng = random.Random(seed + 9)
    prompts = [[rng.randrange(3, PHI3_MINI_4K["vocab_size"])
                for _ in range(2100)] for _ in range(4)]
    out = {}
    for label, layers, dtype, tokens in (
            ("fp32, 4 layers", 4, "float32", 32),
            ("bf16, full size", None, "bfloat16", 24)):
        hf = dict(PHI3_MINI_4K)
        if layers:
            hf["num_hidden_layers"] = layers
        tag = f"[journal {label}]"
        with tempfile.TemporaryDirectory() as tmp:
            r = _journal_run(torch, tmp, hf, dtype, prompts, tokens, tag)
        first_diff = next((i for i, (a, b) in enumerate(
            zip(r["want"], r["got"])) if a != b), None)
        if len(r["got"]) != len(r["want"]) and first_diff is None:
            first_diff = min(len(r["got"]), len(r["want"]))
        r["first_diff"] = first_diff
        log(f"{tag} Phi-3-mini widths, killed after {len(r['before'])} of "
            f"{len(r['want'])} tokens, resumed by a fresh server over the same "
            f"journal: first token differing from the uninterrupted "
            f"stream {first_diff} (None = byte-identical); journal "
            f"{r['journal_bytes']} bytes, {r['records']} records, "
            f"{r['appends']} appends, fsync always; replay "
            f"(resume_from_journal) {r['resume_s'] * 1e3:.2f} ms, resumed "
            f"request done in {r['resumed_request_s']:.2f} s; launches of "
            f"the resume {r['launches']}")
        if layers and first_diff is not None:
            fail(f"{tag} the resumed fp32 stream differs from the "
                 f"uninterrupted one at token {first_diff}")
        out[label] = {k: v for k, v in r.items() if k not in ("want",
                                                              "got")}
        _free_device(torch, f"the {label} journal servers")
    return out


# -- phases 20-24: group sizes above 16; KV that leaves the card --------------

# (H, K, D) of the kernel cases at G = H/K above 16: G 24 (48 query heads
# over 2 KV heads) and G 32 (MQA-style, 32 over 1), D 128. The wrappers
# cut G into ceil(G / 16) = 2 head chunks, one launch each
# (flash.head_split), so each call reads K/V twice.
MQA_SHAPES = ((48, 2, 128), (32, 1, 128))
# prompt lengths of the PD phases' 13 requests
PD_LENGTHS = (64, 100, 180, 256, 333, 512, 700, 900, 1024, 1300, 1600,
              1900, 2048)


def _launches_per_call(torch, H, K, D):
    """Kernel launches of one call of each wrapper at (H, K, D), on small
    inputs: the split's chunk count, counted where the kernels launch."""
    from ome_tpu_torch.ops import flash, paged
    dev = torch.device("cuda")
    bf = torch.bfloat16
    q1 = torch.randn(1, 1, H, D, device=dev).to(bf)
    kv = torch.randn(1, 128, K, D, device=dev).to(bf)
    one = torch.ones(1, dtype=torch.int32, device=dev)
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    pool = torch.randn(2, 128, K, D, device=dev).to(bf)
    table = torch.ones(1, 1, dtype=torch.int32, device=dev)
    kq, ks = flash.quantize_kv_block(kv)
    calls = {
        "flash_decode": lambda: flash.flash_decode(q1, kv, kv, zero, one,
                                                   D ** -0.5),
        "flash_prefill": lambda: flash.flash_prefill(
            torch.randn(1, 64, H, D, device=dev).to(bf), kv, kv, zero,
            one * 64, D ** -0.5),
        "flash_paged_decode": lambda: paged.paged_flash_decode(
            q1, pool, pool, table, one * 100),
        "flash_decode_quantized": lambda: flash.flash_decode_quantized(
            q1, kq, kq, ks, ks, one[:, None] * 99, one * 100),
    }
    out = {}
    for name, fn in calls.items():
        before = flash.LAUNCHES[name]
        fn()
        torch.cuda.synchronize()
        out[name] = flash.LAUNCHES[name] - before
    return out


def phase_mqa_kernels(torch):
    """B1 (bf16 and fp32 at the 8B lengths), B2 (causal 2048, bf16), B3
    (bf16 and int8 pools) and B5 at G 24 and G 32, D 128, each against
    its plain version with its existing tolerance, timed beside its bound
    and (B1, B2) masked SDPA; the bf16 decode cases repeat their bits and
    give a sequence alone the bits it has in the batch. Each wrapper's
    launches per call are counted (2 at both group sizes)."""
    from ome_tpu_torch.ops import flash
    gen = torch.Generator(device="cuda")
    gen.manual_seed(10)
    timer = Timer(torch, torch.device("cuda"))
    lengths = [0, 1, 17, 128, 300, 1023, 2049, 4095]
    plens = [1, 17, 128, 300, 1023, 2049, 4095, 4096]
    cases = {"flash_decode": [], "flash_prefill": [],
             "flash_paged_decode": [], "flash_decode_quantized": []}
    per_call = {}
    for H, K, D in MQA_SHAPES:
        G = H // K
        per_call[G] = _launches_per_call(torch, H, K, D)
        want = len(flash.group_chunks(G))
        if any(n != want for n in per_call[G].values()):
            fail(f"G {G}: launches per call {per_call[G]}, expected {want} "
                 f"(one per head chunk)")
        made = {"flash_decode": [decode_case(
                    torch, timer, gen, dt, lengths, H=H, K=K, D=D,
                    check_bits=dt == "bf16") for dt in ("bf16", "fp32")],
                "flash_prefill": [prefill_case(
                    torch, timer, gen, "bf16", 2048, 2048, 0, H=H, K=K,
                    D=D)],
                "flash_paged_decode": [paged_case(
                    torch, timer, gen, pool_name, plens, H=H, K=K, D=D,
                    check_bits=True) for pool_name in ("bf16", "int8")],
                "flash_decode_quantized": [quantized_case(
                    torch, timer, gen, lengths, H=H, K=K, D=D)]}
        for name, rows in made.items():
            for c in rows:
                c["G"], c["launches_per_call"] = G, per_call[G][name]
                lib = c["library_ms"]
                log(f"[mqa] {name} G {G}: {c['case']}: ms {c['ms']:.4f}, "
                    f"bound {c['bound_ms']:.4f} ms ({c['bound_by']}), share "
                    f"{c['bound_ms'] / c['ms']:.3f}, plain "
                    f"{c['plain_ms']:.4f} ms, masked SDPA "
                    f"{'null' if lib is None else f'{lib:.4f} ms'}; "
                    f"{c['launches_per_call']} launches per call (K/V read "
                    f"{c['launches_per_call']}x)")
            cases[name] += rows
    check_cases(cases)
    return {"cases": cases, "launches_per_call": per_call}


def phase_mqa_identity(torch, seed: int = 0, n_layers: int = 4,
                       steps: int = 32):
    """Llama-3-8B widths at H 32, K 1 (G 32), `n_layers` deep, fp32,
    through the engine API: the dense engine (B1, two head chunks per
    call) and the paged engine over fp32 pools (B3, two head chunks)
    give identical greedy streams for 4 prompts."""
    import random

    from ome_tpu_torch.engine.core import InferenceEngine
    from ome_tpu_torch.models.config import llama3_8b
    from ome_tpu_torch.models.params import init_params
    from ome_tpu_torch.ops import flash

    cfg = llama3_8b().replace(num_layers=n_layers, num_kv_heads=1,
                              dtype=torch.float32)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    params = init_params(cfg, gen, torch.device("cuda"))
    rng = random.Random(seed + 6)
    prompts = [[rng.randrange(3, cfg.vocab_size) for _ in range(n)]
               for n in (37, 200, 515, 1000)]
    streams, gaps = {}, {}
    flash.reset_launches()
    for name, kw in (("dense", {}), ("paged", {"kv_block": 128})):
        eng = InferenceEngine(params, cfg, max_slots=4, max_seq=2048,
                              device="cuda", seed=seed, **kw)
        streams[name], gaps[name], _ = _greedy_streams(torch, eng, prompts,
                                                       steps)
        del eng
    launches = dict(flash.LAUNCHES)
    for name in ("flash_decode", "flash_paged_decode", "flash_prefill"):
        if launches[name] <= 0:
            fail(f"G 32 identity: {name} did not run ({launches})")
    for slot in range(len(prompts)):
        a, b = streams["dense"][slot], streams["paged"][slot]
        if a != b:
            step = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
            fail(f"G 32 identity: prompt {slot} differs at step {step} "
                 f"(dense {a[step]}, paged {b[step]})")
    min_gap = min(float(g[:len(prompts)].min()) for g in gaps["dense"])
    log(f"[mqa] fp32, Llama-3-8B widths at H 32, K 1 (G 32), {n_layers} "
        f"layers: dense (flash_decode) and paged fp32 pool "
        f"(flash_paged_decode) give identical {steps}-token greedy "
        f"streams for {len(prompts)} prompts (smallest top-2 logit gap "
        f"{min_gap:.3e}); launches {launches}")
    del params
    return {"streams_identical": True, "min_top2_gap": min_gap,
            "launches": launches}


class _Node:
    """One server of phases 22-24, built through serve.build_server
    on the 8B shape (bf16, random weights from the seed), with its
    request log and every Request it admitted, read back in process."""

    def __init__(self, tmp: str, name: str, seed: int, *argv):
        from ome_tpu_torch.engine import serve
        self.reqlog = os.path.join(tmp, f"{name}.jsonl")
        self.server, self.sched, self.engine = serve.build_server(
            ["--model-dir", tmp, "--random-weights", "--seed", str(seed),
             "--max-slots", "8", "--max-seq", "4096", "--port", "0",
             "--host", "127.0.0.1", "--request-log", self.reqlog, *argv])
        self.url = f"http://127.0.0.1:{self.server.port}"
        self.seen = []
        submit = getattr(self.sched, "submit")

        def recording_submit(req):
            self.seen.append(req)
            return submit(req)
        self.sched.submit = recording_submit

    def request(self, ids):
        """The last Request this node admitted for the prompt `ids`."""
        for req in reversed(self.seen):
            if list(req.prompt_ids) == list(ids):
                return req
        fail(f"no request with a {len(ids)}-token prompt was admitted")

    def stream(self, ids):
        return list(self.request(ids).output_ids)

    def records(self):
        with open(self.reqlog) as f:
            return [json.loads(line) for line in f]

    def stop(self):
        self.server.stop()


def _post_h(url: str, body: dict, headers=None, timeout: float = 600):
    import urllib.request
    req = urllib.request.Request(
        url + "/v1/completions", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read()


def _send_all(node, prompts, max_tokens=32, what="request"):
    """The prompts at once (a thread each), greedy; all must answer."""
    import concurrent.futures
    with concurrent.futures.ThreadPoolExecutor(len(prompts)) as ex:
        futs = [ex.submit(_post_h, node.url, {"prompt": p,
                                              "max_tokens": max_tokens,
                                              "temperature": 0.0})
                for p in prompts]
        for i, f in enumerate(futs):
            _completion(*f.result(), max_tokens, f"{what} {i}")
    return [node.stream(p) for p in prompts]


def _medians(records):
    ttft = [r["ttft_s"] for r in records if r.get("ttft_s") is not None]
    tpot = [r["tpot_s"] for r in records if r.get("tpot_s")]
    return statistics.median(ttft), statistics.median(tpot)


def _bits_equal(torch, a, b) -> bool:
    return a.shape == b.shape and bool(torch.equal(
        _bits(torch, a.cpu()), _bits(torch, b.cpu())))


def _pinned_pool_ab(torch, shape, n: int = 64):
    """Seconds per block of a device-to-host copy of one bf16 plane of
    `shape` into freshly allocated pinned memory (the host tier's way,
    through the caching host allocator) and into slices of one pinned
    pool allocated up front, each copy waited on, in turns."""
    block = torch.randn(shape, device="cuda").to(torch.bfloat16)
    pool = torch.empty((n,) + tuple(block.shape), dtype=block.dtype,
                       pin_memory=True)
    times = {}
    for name in ("per_block", "pool", "per_block", "pool"):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for i in range(n):
            dst = (torch.empty(block.shape, dtype=block.dtype,
                               pin_memory=True) if name == "per_block"
                   else pool[i])
            dst.copy_(block, non_blocking=True)
            torch.cuda.current_stream().synchronize()
        times.setdefault(name, []).append((time.monotonic() - t0) / n)
    return {k: min(v) for k, v in times.items()}


def _stall_probe(torch, node, steps, load, window_s: float = 1.5):
    """The median decode step period of one request decoding alone, over
    `window_s` before this thread runs `load(deadline)` and over the
    `window_s` while it runs. Returns (before ms, during ms, periods
    before, periods during, what `load` returned)."""
    import concurrent.futures
    ex = concurrent.futures.ThreadPoolExecutor(1)
    fut = ex.submit(_post_h, node.url, {"prompt": list(range(3, 15)),
                                        "max_tokens": 120,
                                        "temperature": 0.0})
    time.sleep(0.5)
    t_before = time.monotonic()
    time.sleep(window_s)
    t0 = time.monotonic()
    got = load(t0 + window_s)
    t1 = time.monotonic()
    _completion(*fut.result(), 120, "the probe's decoding request")
    ex.shutdown()

    def median_in(a, b):
        ps = [y - x for x, y in zip(steps, steps[1:]) if x >= a and y <= b]
        return (statistics.median(ps) * 1e3 if ps else None), len(ps)
    before, n_b = median_in(t_before, t0)
    during, n_d = median_in(t0, t1)
    return before, during, n_b, n_d, got


def _spill_stall_probes(torch, node, spill, block, steps, block_shape):
    """Does a spill stall a decode step? Three loads, each run by this
    thread beside one decoding request (`_stall_probe`): the tier's own
    `spill` of 4 MiB blocks made beforehand (paths no prompt has), the
    same blocks' planes copied into one pinned pool allocated up front
    (no tier, no pinned allocation per block), and a pure-Python loop
    that touches no CUDA (what holding the interpreter lock alone
    costs). Returns each load's (before ms, during ms, periods, GB/s)."""
    src = [tuple(torch.randn(block_shape, device="cuda").to(torch.bfloat16)
                 for _ in range(2)) for _ in range(64)]
    pool = torch.empty((len(src), 2) + tuple(block_shape),
                       dtype=torch.bfloat16, pin_memory=True)
    stream = torch.cuda.Stream()
    nbytes = 2 * math.prod(block_shape) * 2
    torch.cuda.synchronize()
    counter = [0]

    def tier_spill(deadline):
        n = 0
        while time.monotonic() < deadline:
            items = []
            for kv in src[:16]:
                counter[0] += 1
                items.append((tuple([-counter[0]] * block),
                              {"kv": kv, "ready": None, "children": {},
                               "last": 0}))
            spill(items)
            n += len(items)
        return n

    def pool_copy(deadline):
        n = 0
        while time.monotonic() < deadline:
            for i, (k, v) in enumerate(src[:16]):
                with torch.cuda.stream(stream):
                    pool[i, 0].copy_(k, non_blocking=True)
                    pool[i, 1].copy_(v, non_blocking=True)
                stream.synchronize()
            n += 16
        return n

    def python_loop(deadline):
        n = 0
        while time.monotonic() < deadline:
            n += sum(range(1000)) > 0
        return 0
    out = {}
    for name, load in (("tier_spill", tier_spill), ("pinned_pool", pool_copy),
                       ("python_loop", python_loop)):
        t0 = time.monotonic()
        before, during, n_b, n_d, blocks = _stall_probe(torch, node, steps,
                                                        load)
        out[name] = {"before_ms": before, "during_ms": during,
                     "periods": [n_b, n_d], "blocks": blocks,
                     "gbps": blocks * nbytes / 1.5 / 1e9}
        out[name]["s"] = time.monotonic() - t0
    return out


def phase_host_tier(torch, seed: int = 0, n_layers: int = CUT_LAYERS):
    """The prefix cache's host tier at the Llama-3-8B widths, `n_layers`
    deep, bf16, through `serve.build_server` with `--prefix-cache-mb
    8 x n_layers --prefix-cache-host-mb 64 x n_layers` (blocks of 32
    tokens, 128 KiB per layer: the device tier holds one 2048-token
    prefix at any depth; at 8 layers, 64 and 512 MB). Six seeded
    2048-token prefixes are
    sent twice in a row, each time with its own 16-token tail (the second
    send hits on the device: the put of a prefix evicts the one before it
    whole, LRU over the trie's leaves), while a long request decodes
    beside them;
    two fresh 2048-token prompts then push the rest out to the host;
    then each prefix's second prompt again: a host hit queues the
    swap-in and recomputes, and after `drain_swapins` the same prompt
    hits on the swapped-in blocks. Prints the blocks and GB spilled,
    spill and swap-in GB/s, host bytes, host hits, recomputes, TTFT of
    cold, device-hit and swapped-in requests, and the decode step period
    while a spill is in flight against the rest. Holds: a swapped-in
    block's bits equal its spill and the block first computed; every
    prefix's device hit and swapped-in hit are the whole 2048 tokens,
    even where the recomputing prefill's put lands among the swap-ins;
    the streams served from swapped-in blocks equal those served from
    device-resident hits; tier and pool conservation at idle."""
    import random
    import tempfile

    from ome_tpu_torch.models.config import llama3_8b

    cfg = llama3_8b().replace(num_layers=n_layers)
    dev_mb, host_mb = 8 * n_layers, 64 * n_layers
    rng = random.Random(seed + 10)

    def prompt(n):
        return [rng.randrange(3, cfg.vocab_size) for _ in range(n)]
    block = 32
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "config.json"), "w") as f:
            json.dump(_hf_config(cfg), f)
        node = _Node(tmp, "host_tier", seed, "--prefix-cache-mb",
                     str(dev_mb), "--prefix-cache-host-mb", str(host_mb))
        eng, pc = node.engine, node.engine.prefix_cache
        spills, uploads, matched, steps = [], [], {}, []
        orig_spill, orig_upload = pc._spill, pc._upload
        orig_match, orig_decode = pc.match, eng.decode

        def timed_spill(items):
            # the wait for the blocks' own copy-out (behind the prefill
            # that made them) is timed apart from the copies
            t0 = time.monotonic()
            for _, nd in items:
                if nd.get("ready") is not None:
                    nd["ready"].synchronize()
            t1 = time.monotonic()
            nbytes = sum(pc._leaf_bytes(*nd["kv"]) for _, nd in items)
            orig_spill(items)
            if items:
                spills.append((t0, time.monotonic(), len(items), nbytes,
                               t1 - t0))

        def timed_upload(ks, vs):
            t0 = time.monotonic()
            kd, vd = orig_upload(ks, vs)
            uploads.append((time.monotonic() - t0, pc._leaf_bytes(kd, vd),
                            kd.data_ptr()))
            return kd, vd

        def recorded_match(ids, usable=None):
            hit = orig_match(ids, usable)
            matched[tuple(ids)] = 0 if hit is None else hit[2]
            return hit

        def timed_decode(*a, **kw):
            steps.append(time.monotonic())
            return orig_decode(*a, **kw)
        pc._spill, pc._upload, pc.match = timed_spill, timed_upload, \
            recorded_match
        eng.decode = timed_decode
        try:
            prefixes = [prompt(2048) for _ in range(6)]
            tails = [(prompt(16), prompt(16)) for _ in range(6)]
            import concurrent.futures
            bg_ex = concurrent.futures.ThreadPoolExecutor(1)
            # a 12-token prompt: under the cache's 16-token minimum, so
            # the long request takes no room in the device tier
            bg = bg_ex.submit(_post_h, node.url, {
                "prompt": prompt(12), "max_tokens": 256,
                "temperature": 0.0})
            ttft = {"cold": [], "device_hit": [], "swapped_in": []}

            def send(ids, kind):
                _completion(*_post_h(node.url, {"prompt": ids,
                                                "max_tokens": 8,
                                                "temperature": 0.0}),
                            8, kind)
                req = node.request(ids)
                if kind in ttft:
                    ttft[kind].append(req.first_token_at - req.created)
                return list(req.output_ids)
            first_hit = {}
            first_block = None
            for i, (p, (ta, tb)) in enumerate(zip(prefixes, tails)):
                send(p + ta, "cold")
                if i == 0:
                    nd = pc._root[tuple(p[:block])]
                    first_block = nd["kv"][0].cpu()
                ids = p + tb
                first_hit[i] = (send(ids, "device_hit"), matched[tuple(ids)])
            for _ in range(2):
                send(prompt(2048), "push")
            _completion(*bg.result(), 256, "the long request")
            bg_ex.shutdown()
            _wait_idle(node.sched)
            path0 = tuple(prefixes[0][:block])
            if path0 not in pc._host:
                fail("host tier: the first prefix's first block was not "
                     "spilled to the host tier")
            spilled0 = pc._host[path0][0].clone()
            out["after_spills"] = {
                "device_bytes": pc.bytes, "host_bytes": pc.host_bytes,
                "evictions": pc.evictions,
                "spilled_blocks": sum(s[2] for s in spills),
                "spilled_bytes": sum(s[3] for s in spills)}
            swapped, host_hits0 = {}, pc.host_hits
            for i, (p, (_, tb)) in enumerate(zip(prefixes, tails)):
                ids = p + tb
                send(ids, "host_hit")          # recomputes, queues swap-in
                pc.drain_swapins(timeout=120.0)
                swapped[i] = (send(ids, "swapped_in"), matched[tuple(ids)])
                if i == 0:
                    node0 = pc._root[path0]["kv"][0]
                    uploaded = {u[2] for u in uploads}
                    out["block0_swapped_in"] = node0.data_ptr() in uploaded
                    out["block0_bits_equal_spill"] = _bits_equal(
                        torch, node0, spilled0)
                    out["spill_bits_equal_first"] = _bits_equal(
                        torch, spilled0, first_block)
            out["stall_probe"] = _spill_stall_probes(
                torch, node, orig_spill, block, steps, first_block.shape)
            _wait_idle(node.sched)
            out["tier_conservation"] = pc.tier_conservation()
            out["kv_conservation"] = eng.kv_conservation()
        finally:
            pc._spill, pc._upload, pc.match = orig_spill, orig_upload, \
                orig_match
            eng.decode = orig_decode
            node.stop()
        block_bytes = 2 * first_block.numel() * first_block.element_size()
    if not (out["block0_swapped_in"] and out["block0_bits_equal_spill"]
            and out["spill_bits_equal_first"]):
        fail(f"host tier: the first prefix's first block: swapped in "
             f"{out['block0_swapped_in']}, bits equal to its spill "
             f"{out['block0_bits_equal_spill']}, spill equal to the block "
             f"first computed {out['spill_bits_equal_first']}")
    short = {i: (first_hit[i][1], swapped[i][1]) for i in range(6)
             if (first_hit[i][1], swapped[i][1]) != (2048, 2048)}
    if short:
        fail(f"host tier: (device hit, swapped-in hit) tokens short of the "
             f"whole 2048-token prefix: {short}")
    same = [i for i in range(6) if first_hit[i][0] == swapped[i][0]]
    if len(same) != 6:
        fail(f"host tier: the streams from swapped-in blocks differ from "
             f"the device-hit streams for prefixes "
             f"{sorted(set(range(6)) - set(same))}")
    if not out["tier_conservation"][0] or not out["kv_conservation"][0]:
        fail(f"host tier: at idle tier_conservation "
             f"{out['tier_conservation']}, kv_conservation "
             f"{out['kv_conservation']}")
    spill_s = sum(s[1] - s[0] - s[4] for s in spills)
    spill_wait_s = sum(s[4] for s in spills)
    spill_b = sum(s[3] for s in spills)
    up_s = sum(u[0] for u in uploads)
    up_b = sum(u[1] for u in uploads)
    periods = [(b - a, any(s[0] < b and s[1] > a for s in spills))
               for a, b in zip(steps, steps[1:])]
    during = [p for p, hit in periods if hit]
    outside = [p for p, hit in periods if not hit]
    out.update({
        "spills": len(spills), "spilled_blocks": sum(s[2] for s in spills),
        "spilled_gb": spill_b / 1e9, "spill_s": spill_s,
        "spill_wait_s": spill_wait_s,
        "spill_gbps": spill_b / spill_s / 1e9 if spill_s else None,
        "swapins": pc.host_swapins, "swapin_gb": up_b / 1e9,
        "swapin_s": up_s,
        "swapin_gbps": up_b / up_s / 1e9 if up_s else None,
        "host_bytes": pc.host_bytes, "host_hits": pc.host_hits,
        "host_hits_final_round": pc.host_hits - host_hits0,
        "host_recomputes": pc.host_recomputes, "hits": pc.hits,
        "block_bytes": block_bytes,
        "ttft_median_s": {k: statistics.median(v) for k, v in ttft.items()},
        "ttft_s": ttft,
        "hit_tokens": {i: (first_hit[i][1], swapped[i][1])
                       for i in range(6)},
        "streams_equal_prefixes": same,
        "step_period_median_ms": {
            "spill_in_flight": statistics.median(during) * 1e3
            if during else None,
            "otherwise": statistics.median(outside) * 1e3
            if outside else None,
            "n": [len(during), len(outside)]},
    })
    ab = _pinned_pool_ab(torch, (cfg.num_layers, 1, block,
                                 cfg.num_kv_heads, cfg.head_dim))
    out["pinned_ms_per_block"] = {k: v * 1e3 for k, v in ab.items()}
    log(f"[host tier] Llama-3-8B widths, {n_layers} layers, bf16, "
        f"--prefix-cache-mb {dev_mb} --prefix-cache-host-mb {host_mb}, "
        f"{block_bytes / 2**20:.0f} MiB per "
        f"block (k + v): {out['spilled_blocks']} blocks "
        f"({out['spilled_gb']:.3f} GB) spilled in {len(spills)} spills at "
        f"{out['spill_gbps']:.2f} GB/s of copies (besides "
        f"{spill_wait_s * 1e3:.1f} ms waiting for the blocks' prefills); "
        f"{out['swapins']} blocks swapped in "
        f"({out['swapin_gb']:.3f} GB) at {out['swapin_gbps']:.2f} GB/s; "
        f"host bytes {out['host_bytes'] / 2**20:.0f} MiB; host hits "
        f"{out['host_hits']}, recomputes {out['host_recomputes']}, device "
        f"hits {out['hits']}")
    log(f"[host tier] TTFT medians (ms): cold "
        f"{out['ttft_median_s']['cold'] * 1e3:.1f}, device hit "
        f"{out['ttft_median_s']['device_hit'] * 1e3:.1f}, swapped in "
        f"{out['ttft_median_s']['swapped_in'] * 1e3:.1f}; hit tokens "
        f"(device hit, swapped in) per prefix {out['hit_tokens']}")
    log(f"[host tier] a swapped-in block's bits equal its spill and the "
        f"block first computed; streams from swapped-in blocks equal the "
        f"device-hit streams for prefixes {same}; "
        f"at idle tier_conservation {out['tier_conservation']}, "
        f"kv_conservation {out['kv_conservation']}")
    sp = out["step_period_median_ms"]
    log(f"[host tier] decode step period of the long request beside the "
        f"traffic: median {sp['spill_in_flight']} ms while a spill was in "
        f"flight, {sp['otherwise']} ms otherwise ({sp['n']} periods; those "
        f"spills run right after the prefill that caused them); a "
        f"device-to-host copy of one plane of a block into fresh pinned "
        f"memory {out['pinned_ms_per_block']['per_block']:.3f} ms, into one "
        f"pinned pool {out['pinned_ms_per_block']['pool']:.3f} ms")
    for name, pr in out["stall_probe"].items():
        log(f"[host tier] stall probe, {name} beside one decoding request: "
            f"median step period {pr['during_ms']} ms during, "
            f"{pr['before_ms']} ms in the window before (periods before, "
            f"during: {pr['periods']}); {pr['blocks']} blocks at "
            f"{pr['gbps']:.2f} GB/s")
    return out


def _pd_breakdown(pre_handler, dec_engine, n):
    """The last `n` PD fetches, in order: the prefill node's prefill and
    gather + serialize seconds beside the decode node's HTTP (less the
    prefill node's work), deserialize, upload and insert seconds."""
    pre = list(pre_handler.timings)[-n:]
    dec = list(dec_engine.timings)[-n:]
    rows = []
    for p, d in zip(pre, dec):
        if p["bytes"] != d["bytes"]:
            fail(f"PD: the fetch records are out of step ({p['bytes']} vs "
                 f"{d['bytes']} bytes)")
        rows.append({"prompt_tokens": p["prompt_tokens"],
                     "bucket": p["bucket"], "bytes": p["bytes"],
                     "prefill_s": p["prefill_s"],
                     "serialize_s": p["serialize_s"],
                     "http_s": d["http_s"] - p["prefill_s"]
                     - p["serialize_s"],
                     "deserialize_s": d["deserialize_s"],
                     "upload_s": d["upload_s"],
                     "insert_s": d.get("insert_s")})
    return rows


def _first_diff(a, b):
    """The first token index where two streams differ (None: equal)."""
    if a == b:
        return None
    return next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                min(len(a), len(b)))


def _pd_through_router(dec, ids, want):
    """One completion through the port's router whose only backend is
    the PD decode node, in the decoder pool (`--backend decoder=URL`):
    the router falls back from the empty engine pool to the decoders,
    and the stream must be the one the node gave directly."""
    from ome_tpu_torch.router import server as rserver
    router = rserver.Router([rserver.Backend(dec.url, "decoder")],
                            health_interval=3600)
    rs = rserver.RouterServer(router, host="127.0.0.1", port=0).start()
    try:
        _completion(*_post_h(f"http://127.0.0.1:{rs.port}", {
            "prompt": ids, "max_tokens": 32, "temperature": 0.0}), 32,
            "PD request through the router")
    finally:
        rs.stop()
    got = dec.stream(ids)
    stats = router.stats
    if got != want:
        fail(f"PD through the router: the stream differs from the decode "
             f"node's direct one at token {_first_diff(got, want)}")
    if stats["requests_total"] != 1 or stats["retries_total"] or \
            stats["no_backend_total"]:
        fail(f"PD through the router: router counters {stats}")
    log(f"[pd router] a {len(ids)}-token request through the port's router "
        f"(decoder pool, the decode node its only backend): the stream the "
        f"decode node gave directly")
    return {"stream_equal": True, "router_stats": stats}


def _pd_pair(torch, tmp, seed, prompts, mono_streams, flags, tag):
    """A prefill node and a decode node with `flags`, the prompts sent to
    the decode node at once: the streams against the monolithic
    server's (bf16: identical; int8 pools: the first tokens identical and
    the drift reported, see phase_pd), the launches of the run, the
    per-request split of the fetch; bf16 also sends one request through
    the port's router in front of the decode node."""
    from ome_tpu_torch.ops import flash
    pre = _Node(tmp, f"{tag}_prefill", seed, "--disaggregation-mode",
                "prefill", *flags)
    dec = _Node(tmp, f"{tag}_decode", seed, "--disaggregation-mode",
                "decode", "--prefill-url", pre.url, *flags)
    try:
        flash.reset_launches()
        streams = _send_all(dec, prompts, what=f"{tag} PD request")
        _wait_idle(dec.sched)
        torch.cuda.synchronize()
        launches = dict(flash.LAUNCHES)
        drift = [_first_diff(a, b) for a, b in zip(mono_streams, streams)]
        for i, step in enumerate(drift):
            if step is not None and (not flags or step == 0):
                fail(f"PD {tag}: request {i} ({len(prompts[i])} tokens) "
                     f"differs from the monolithic stream at token {step}")
        rows = _pd_breakdown(pre.server.pd_prefill, dec.engine,
                             len(prompts))
        out = {"launches": launches, "fetches": rows, "drift": drift,
               "kv_conservation": dec.engine.kv_conservation(),
               "ttft_tpot_median_s": _medians(dec.records())}
        if not flags:
            out["router"] = _pd_through_router(dec, prompts[0], streams[0])
        if dec.engine.local_fallbacks or dec.engine.failovers:
            fail(f"PD {tag}: {dec.engine.failovers} failovers, "
                 f"{dec.engine.local_fallbacks} local fallbacks with a live "
                 f"prefill node")
    finally:
        dec.stop()
    return pre, out


def phase_pd(torch, seed: int = 0, n_layers: int = CUT_LAYERS):
    """PD disaggregation at the Llama-3-8B widths, `n_layers` deep, bf16: a
    monolithic server answers 13 requests of 64 to 2048 tokens; then a
    prefill node (`--disaggregation-mode prefill`) and a decode node
    (`--disaggregation-mode decode --prefill-url`) answer the same
    requests with identical greedy streams, the prefill node launching B2
    and the decode node B1; per request the blob bytes and the fetch's
    split (prefill, gather + serialize, HTTP, deserialize, upload,
    insert), and the TTFT and TPOT medians against the monolithic
    server's. Then with `--kv-block 128 --kv-dtype int8` on every server:
    int8 blobs at about half the bytes, B3 on the decode node, the pool
    conserved, first tokens identical to an int8 monolithic server's and
    each stream's drift from it reported — the wire quantizer (numpy,
    amax / 127) and the pool's (amax x f32(1/127), as XLA compiles the
    reference's) round a few values to neighbouring steps, in the
    reference as here, so the decode node's pool is not the monolithic
    pool bit for bit. Then failover: a decode node with two prefill URLs
    whose first node is stopped after its third fetch completes every
    request with the monolithic streams; and `--pd-local-fallback` with
    no live peer computes the prefill itself."""
    import random
    import tempfile

    from ome_tpu_torch.models.config import llama3_8b
    from ome_tpu_torch.ops import flash

    cfg = llama3_8b().replace(num_layers=n_layers)
    rng = random.Random(seed + 20)
    prompts = [[rng.randrange(3, cfg.vocab_size) for _ in range(n)]
               for n in PD_LENGTHS]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "config.json"), "w") as f:
            json.dump(_hf_config(cfg), f)
        for tag, flags in (("bf16", ()),
                           ("int8", ("--kv-block", "128", "--kv-dtype",
                                     "int8"))):
            mono = _Node(tmp, f"{tag}_mono", seed, *flags)
            try:
                flash.reset_launches()
                mono_streams = _send_all(mono, prompts,
                                         what=f"{tag} monolithic request")
                _wait_idle(mono.sched)
                mono_launches = dict(flash.LAUNCHES)
                mono_med = _medians(mono.records())
            finally:
                mono.stop()
            del mono
            _free_device(torch, f"the {tag} monolithic server")
            pre, res = _pd_pair(torch, tmp, seed, prompts, mono_streams,
                                flags, tag)
            res["mono_launches"] = mono_launches
            res["mono_ttft_tpot_median_s"] = mono_med
            out[tag] = res
            lk = res["launches"]
            need = ["flash_prefill"] + (["flash_paged_decode"] if flags
                                        else ["flash_decode"])
            for name in need:
                if lk[name] <= 0:
                    fail(f"PD {tag}: {name} was never launched ({lk})")
            if not res["kv_conservation"][0]:
                fail(f"PD {tag}: the decode node's pool is not conserved "
                     f"at idle ({res['kv_conservation']})")
            (ttft, tpot), (mttft, mtpot) = (res["ttft_tpot_median_s"],
                                            mono_med)
            same = ("greedy streams identical to the monolithic server's"
                    if not any(res["drift"]) else
                    f"first tokens identical to the monolithic server's, "
                    f"first differing token per request {res['drift']}")
            log(f"[pd {tag}] 13 requests (prompts {PD_LENGTHS[0]}-"
                f"{PD_LENGTHS[-1]} tokens): {same}; TTFT median "
                f"{ttft * 1e3:.1f} ms "
                f"(monolithic {mttft * 1e3:.1f}), TPOT median "
                f"{tpot * 1e3:.2f} ms (monolithic {mtpot * 1e3:.2f}); "
                f"launches {lk} (monolithic {mono_launches})")
            for r in res["fetches"]:
                log(f"[pd {tag}] {r['prompt_tokens']} tokens (bucket "
                    f"{r['bucket']}): blob {r['bytes'] / 2**20:.2f} MiB; "
                    f"prefill {r['prefill_s'] * 1e3:.1f} ms, gather + "
                    f"serialize {r['serialize_s'] * 1e3:.1f}, HTTP "
                    f"{r['http_s'] * 1e3:.1f}, deserialize "
                    f"{r['deserialize_s'] * 1e3:.1f}, upload "
                    f"{r['upload_s'] * 1e3:.1f}, insert (decode thread) "
                    f"{(r['insert_s'] or 0) * 1e3:.2f}")
            if tag == "bf16":
                # failover: a second prefill node; the first is stopped
                # once three requests have answered
                pre2 = _Node(tmp, "prefill2", seed, "--disaggregation-mode",
                             "prefill")
                dec = _Node(tmp, "failover_decode", seed,
                            "--disaggregation-mode", "decode",
                            "--prefill-url", pre.url, "--prefill-url",
                            pre2.url)
                fetched = []
                blob = dec.engine.prefill_blob

                def stop_first_after_three(*a, **kw):
                    data = blob(*a, **kw)
                    fetched.append(dec.engine._last_peer)
                    if fetched.count(pre.url) == 3:
                        pre.stop()  # the admission thread waits for it
                    return data
                dec.engine.prefill_blob = stop_first_after_three
                try:
                    streams = _send_all(dec, prompts,
                                        what="failover request")
                    if streams != mono_streams:
                        fail("PD failover: a stream differs from the "
                             "monolithic server's")
                    out["failover"] = {
                        "failovers": dec.engine.failovers,
                        "fetched_from": fetched}
                finally:
                    dec.stop()
                    pre2.stop()
                if out["failover"]["failovers"] < 1:
                    fail("PD failover: no fetch failed over after the first "
                         "prefill node stopped")
                log(f"[pd failover] two prefill URLs, the first stopped "
                    f"after its third fetch: all 13 requests completed with "
                    f"the monolithic streams; "
                    f"{out['failover']['failovers']} failed fetches failed "
                    f"over")
                del pre2, dec
                _free_device(torch, "the failover servers")
                local = _Node(tmp, "fallback_decode", seed,
                              "--disaggregation-mode", "decode",
                              "--prefill-url", "http://127.0.0.1:9",
                              "--pd-local-fallback",
                              "--pd-attempt-timeout", "5")
                try:
                    streams = _send_all(local, prompts[:3],
                                        what="local fallback request")
                    if streams != mono_streams[:3]:
                        fail("PD local fallback: a stream differs from the "
                             "monolithic server's")
                    out["local_fallbacks"] = local.engine.local_fallbacks
                finally:
                    local.stop()
                if out["local_fallbacks"] < 3:
                    fail(f"PD local fallback: {out['local_fallbacks']} local "
                         f"prefills for 3 requests")
                log(f"[pd fallback] --pd-local-fallback with no live peer: "
                    f"3 requests computed locally "
                    f"({out['local_fallbacks']} fallbacks), streams equal "
                    f"the monolithic server's")
                del local
            pre.stop()  # again after the failover run: a no-op then
            del pre
            _free_device(torch, f"the {tag} PD servers")
    bf16_bytes = {r["prompt_tokens"]: r["bytes"]
                  for r in out["bf16"]["fetches"]}
    ratio = [r["bytes"] / bf16_bytes[r["prompt_tokens"]]
             for r in out["int8"]["fetches"]]
    out["int8_bytes_ratio"] = (min(ratio), max(ratio))
    if max(ratio) > 0.6:
        fail(f"PD int8: blobs at {max(ratio):.3f} of the bf16 bytes")
    log(f"[pd int8] int8 blobs at {min(ratio):.4f}-{max(ratio):.4f} of the "
        f"bf16 blobs' bytes")
    return out


def phase_peering(torch, seed: int = 0):
    """Cross-replica prefix reuse at the Llama-3-8B shape, bf16: a donor
    replica (any replica with a prefix cache serves /pd/prefill) holds a
    1500-token prompt's prefix; a plain replica asked for the same prompt
    with `X-OME-Prefix-Peer` naming the donor fetches the KV instead of
    computing it. Holds: its stream equals the one the donor serves from
    its own cache for that prompt, and equals its own next answer from
    the cache the fetch seeded; the peer-fetch counter reads 1."""
    import random
    import tempfile
    import urllib.request

    from ome_tpu_torch.models.config import llama3_8b

    cfg = llama3_8b().replace(num_layers=CUT_LAYERS)
    rng = random.Random(seed + 30)
    ids = [rng.randrange(3, cfg.vocab_size) for _ in range(1500)]
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "config.json"), "w") as f:
            json.dump(_hf_config(cfg), f)
        donor = _Node(tmp, "donor", seed)
        plain = _Node(tmp, "plain", seed)
        try:
            body = {"prompt": ids, "max_tokens": 32, "temperature": 0.0}
            _completion(*_post_h(donor.url, body), 32, "donor cold")
            _completion(*_post_h(donor.url, body), 32, "donor hit")
            want = donor.stream(ids)
            _completion(*_post_h(plain.url, body,
                                 {"X-OME-Prefix-Peer": donor.url}), 32,
                        "peer fetch")
            got = plain.stream(ids)
            client = plain.sched._peer_client
            fetches = client.fetches if client is not None else 0
            _completion(*_post_h(plain.url, body), 32, "seeded hit")
            again = plain.stream(ids)
            with urllib.request.urlopen(plain.url + "/metrics",
                                        timeout=30) as r:
                metrics = r.read().decode()
            counter = [ln for ln in metrics.splitlines() if ln.startswith(
                "ome_engine_prefix_peer_fetches_total")]
        finally:
            donor.stop()
            plain.stop()
    if fetches != 1 or counter != ["ome_engine_prefix_peer_fetches_total 1"]:
        fail(f"peering: peer fetches {fetches}, metric {counter}")
    if got != want or again != want:
        fail("peering: the peer-fetched stream (or the seeded-cache one) "
             "differs from the donor's")
    log(f"[peering] 1500-token prompt with X-OME-Prefix-Peer naming the "
        f"donor: 1 peer fetch ({counter[0]}); the stream equals the donor's "
        f"own answer from its cache, and the replica's next answer from the "
        f"cache the fetch seeded")
    return {"peer_fetches": fetches, "streams_identical": True}


# -- phase 24a: the router in front of the replicas ---------------------------


ROUTER_PREFIX_TOKENS = 1500
ROUTER_ASYNC_STREAMS = 32


def _sse(url: str, body: dict, headers=None, timeout: float = 600):
    """POST a streaming completion; (events, seconds from the request to
    the stream's end) as the client saw them. (The time to the first
    event says nothing here: the byte-level tokenizer emits no text for
    most of a random model's tokens, so a stream's first event can come
    late.)"""
    import urllib.request
    req = urllib.request.Request(
        url + "/v1/completions",
        data=json.dumps({**body, "stream": True}).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    t0 = time.monotonic()
    with urllib.request.urlopen(req, timeout=timeout) as r:
        events = [raw.decode().strip() for raw in r
                  if raw.startswith(b"data:")]
    if not events or events[-1] != "data: [DONE]":
        fail(f"router: a stream from {url} ended without [DONE]")
    return events, time.monotonic() - t0


def _routed_records(path: str) -> dict:
    """{trace id: router request-log record} of a router's log."""
    with open(path) as f:
        return {r["trace_id"]: r for r in map(json.loads, f)}


class _Traces:
    """Streaming requests of a kind (direct, through a router), each
    with a W3C traceparent minted here: the replicas' request-log records
    keep the caller's trace id, through a router too, so each record is
    told apart by kind and joined to the client's time for it."""

    def __init__(self, seed: int):
        import random
        self._rng = random.Random(seed)
        self.ids = {}
        self.client_s = {}

    def header(self, kind: str):
        trace = "%032x" % self._rng.getrandbits(128)
        self.ids.setdefault(kind, set()).add(trace)
        return trace, {"traceparent":
                       f"00-{trace}-{self._rng.getrandbits(64):016x}-01"}

    def stream(self, kind: str, url: str, body: dict, header=None):
        """One streaming request of `kind`; its events."""
        trace, h = header or self.header(kind)
        events, self.client_s[trace] = _sse(url, body, h)
        return events

    def medians(self, nodes, kind: str) -> dict:
        """Over the replicas' records of one kind of request: TTFT and
        TPOT medians, and the median of the client's time less the
        replica's e2e for the same request (what the hops in front of
        the replica add)."""
        recs = [r for n in nodes for r in n.records()
                if r.get("trace_id") in self.ids.get(kind, ())]
        ttft, tpot = _medians(recs)
        hop = statistics.median(self.client_s[r["trace_id"]] - r["e2e_s"]
                                for r in recs)
        return {"n": len(recs), "ttft_s": ttft, "tpot_s": tpot,
                "added_s": hop}


def phase_router(torch, seed: int = 0):
    """The port's routers in front of two replicas at the Llama-3-8B
    widths, `CUT_LAYERS` deep, bf16, prefix caches on (`_Node`), with
    B1 and B2 launched through them. Threaded `RouterServer`,
    `cache_aware`:
    1. affinity: three seeded 1500-token prompts, each sent twice through
       the router (greedy, 32 tokens): both land on the replica the
       rendezvous hash names (the router's request log), the second is a
       device prefix-cache hit there, and it equals that replica's direct
       answer to the same prompt (a hit too); the first (cold) equals the
       cold direct answer of the other replica, which holds the same
       weights and runs the same kernels;
    2. learn and inject: a fourth prompt served directly by the replica
       the hash does not pick; after one health sweep the router's prefix
       directory names it owner, and the prompt through the router
       carries X-OME-Prefix-Peer to the picked replica, which fetches the
       prefix KV from the owner (its `ome_engine_prefix_peer_fetches_total`
       reads 1) and answers the owner's tokens;
    3. `AsyncRouterServer` in front of the same replicas: 32 concurrent
       SSE streams over the four prompts all complete, each with the
       tokens the threaded router gave for its prompt; then the same 32
       sent directly to the replicas, for comparison;
    4. failover: one replica stopped, the prompt that hashes to it is
       served by the other (twice, the threaded router retrying once),
       `/health` shows it down and the counters read one retry, no 503.
    Printed, not bounded: on the same prefix-hit streams (a second round
    of step 1's prompts, through the threaded router and direct, and
    step 3's 32 streams through the asyncio router and direct), TTFT and
    TPOT medians from the replicas' request logs (each kind of request
    told apart by the trace id it sent), and the median of the client's
    time less the replica's e2e for the same request: what the hops in
    front of the replica add."""
    import concurrent.futures
    import random
    import tempfile
    import urllib.request

    from ome_tpu_torch.models.config import llama3_8b
    from ome_tpu_torch.ops import flash
    from ome_tpu_torch.router import aserver as rasync
    from ome_tpu_torch.router import server as rserver

    cfg = llama3_8b().replace(num_layers=CUT_LAYERS)
    rng = random.Random(seed + 40)
    prompts = [[rng.randrange(3, cfg.vocab_size)
                for _ in range(ROUTER_PREFIX_TOKENS)] for _ in range(4)]

    def body(ids):
        return {"prompt": ids, "max_tokens": 32, "temperature": 0.0}
    out = {}
    tr = _Traces(seed)
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "config.json"), "w") as f:
            json.dump(_hf_config(cfg), f)
        nodes = [_Node(tmp, f"replica{i}", seed) for i in range(2)]
        urls = [n.url for n in nodes]
        rlog = os.path.join(tmp, "router.jsonl")
        alog = os.path.join(tmp, "arouter.jsonl")
        router = rserver.Router([rserver.Backend(u) for u in urls],
                                policy="cache_aware", health_interval=3600)
        rs = rserver.RouterServer(router, host="127.0.0.1", port=0,
                                  request_log=rlog).start()
        base = f"http://127.0.0.1:{rs.port}"
        # the replica the rendezvous hash names for each prompt, from a
        # router of its own over the same URLs (no side effects)
        hash_pick = rserver.Router([rserver.Backend(u) for u in urls])
        picked = [urls.index(hash_pick.pick(
            "engine", rserver.affinity_from_payload(body(p))).url)
            for p in prompts]
        ars = None
        try:
            flash.reset_launches()
            # 1. affinity
            streams = {}
            for i, ids in enumerate(prompts[:3]):
                k = picked[i]
                _completion(*_post_h(urls[1 - k], body(ids)), 32,
                            f"router: prompt {i} cold, direct to the "
                            f"other replica")
                cold_other = nodes[1 - k].stream(ids)
                hits0 = nodes[k].engine.prefix_cache.hits
                _completion(*_post_h(base, body(ids)), 32,
                            f"router: prompt {i}, first")
                first = nodes[k].stream(ids)
                hits1 = nodes[k].engine.prefix_cache.hits
                tr.stream("warm-up", base, body(ids))
                second = nodes[k].stream(ids)
                hits2 = nodes[k].engine.prefix_cache.hits
                tr.stream("warm-up", urls[k], body(ids))
                direct = nodes[k].stream(ids)
                if (hits1 - hits0, hits2 - hits1) != (0, 1):
                    fail(f"router: prompt {i}: prefix-cache hits "
                         f"{hits1 - hits0} then {hits2 - hits1} on replica "
                         f"{k} (want 0 then 1)")
                if second != direct:
                    fail(f"router: prompt {i}: the routed hit differs from "
                         f"replica {k}'s direct answer at token "
                         f"{_first_diff(second, direct)}")
                if first != cold_other:
                    fail(f"router: prompt {i}: the routed cold answer "
                         f"differs from the other replica's cold answer at "
                         f"token {_first_diff(first, cold_other)}")
                streams[i] = second
                out.setdefault("cold_equals_hit", []).append(first == second)
            landed = [r["backend"] for r in
                      _routed_records(rlog).values()]
            want = [urls[picked[i]] for i in range(3) for _ in range(2)]
            if landed != want:
                fail(f"router: affinity: the router's log has {landed}, "
                     f"the hash names {want}")
            # a timed round: the same hits again, now that each
            # replica's program for a hit has run once (a program's first
            # dispatch carries the ledger's FLOP count)
            for i, ids in enumerate(prompts[:3]):
                for kind, url in (("threaded", base),
                                  ("direct", urls[picked[i]])):
                    tr.stream(kind, url, body(ids))
                    if nodes[picked[i]].stream(ids) != streams[i]:
                        fail(f"router: prompt {i}: the timed {kind} hit "
                             f"differs from the first")
            log(f"[router] affinity: 3 prompts of {ROUTER_PREFIX_TOKENS} "
                f"tokens, 2 requests each through the cache_aware router, "
                f"each pair on one replica ({[picked[i] for i in range(3)]}),"
                f" the second a device prefix-cache hit equal to the "
                f"replica's direct answer; the first equal to the other "
                f"replica's cold answer; cold = hit: "
                f"{out['cold_equals_hit']}")
            # 2. learn and inject
            ids = prompts[3]
            k, o = picked[3], 1 - picked[3]
            _completion(*_post_h(urls[o], body(ids)), 32,
                        "router: the owner's cold answer")
            _completion(*_post_h(urls[o], body(ids)), 32,
                        "router: the owner's hit")
            owner_stream = nodes[o].stream(ids)
            router.check_health_once()
            digest = rserver.prefix_digest(
                rserver.affinity_from_payload(body(ids)))
            if router.prefix_directory.lookup(digest) != urls[o]:
                fail(f"router: after a health sweep the directory names "
                     f"{router.prefix_directory.lookup(digest)} for the "
                     f"fourth prompt, not its owner {urls[o]}")
            _completion(*_post_h(base, body(ids)), 32,
                        "router: the injected request")
            got = nodes[k].stream(ids)
            fetches = _scrape(urls[k]).get(
                "ome_engine_prefix_peer_fetches_total")
            stats = router.stats
            if fetches != 1 or stats[
                    "prefix_directory_peer_fetches_total"] != 1:
                fail(f"router: inject: replica {k} counts {fetches} peer "
                     f"fetches, the router {stats}")
            if got != owner_stream:
                fail(f"router: inject: the fetched stream differs from the "
                     f"owner's at token {_first_diff(got, owner_stream)}")
            streams[3] = got
            log(f"[router] learn and inject: replica {o} served the fourth "
                f"prompt, one health sweep put it in the directory, the "
                f"request through the router went to replica {k} with "
                f"X-OME-Prefix-Peer: 1 peer fetch there "
                f"(ome_engine_prefix_peer_fetches_total {fetches:g}), the "
                f"owner's stream")
            # 3. the asyncio router, 32 concurrent streams
            arouter = rserver.Router([rserver.Backend(u) for u in urls],
                                     policy="cache_aware",
                                     health_interval=3600)
            ars = rasync.AsyncRouterServer(arouter, host="127.0.0.1",
                                           port=0, request_log=alog).start()
            abase = f"http://127.0.0.1:{ars.port}"
            marks = [len(n.seen) for n in nodes]
            order = [j % 4 for j in range(ROUTER_ASYNC_STREAMS)]
            with concurrent.futures.ThreadPoolExecutor(
                    ROUTER_ASYNC_STREAMS) as ex:
                futs = [ex.submit(tr.stream, "async", abase,
                                  body(prompts[j]), tr.header("async"))
                        for j in order]
                results = [f.result() for f in futs]
            admitted = [(j, list(r.prompt_ids), list(r.output_ids))
                        for j, n in enumerate(nodes)
                        for r in n.seen[marks[j]:]]
            if len(admitted) != ROUTER_ASYNC_STREAMS:
                fail(f"router: async: {len(admitted)} requests admitted for "
                     f"{ROUTER_ASYNC_STREAMS} streams")
            for j, pids, toks in admitted:
                i = prompts.index(pids)
                if j != picked[i] or toks != streams[i]:
                    fail(f"router: async: prompt {i} on replica {j} gave "
                         f"tokens differing from the threaded router's at "
                         f"{_first_diff(toks, streams[i])}")
            texts = {}
            for j, events in zip(order, results):
                texts.setdefault(j, set()).add("".join(
                    json.loads(e[len("data: "):])["choices"][0]["text"]
                    for e in events[:-1]))
            if any(len(v) != 1 for v in texts.values()):
                fail("router: async: streams of one prompt differ in text")
            ars.stop()
            ars = None
            # the same 32 streams sent directly, each to its prompt's
            # replica: the async router's numbers beside direct ones
            marks = [len(n.seen) for n in nodes]
            with concurrent.futures.ThreadPoolExecutor(
                    ROUTER_ASYNC_STREAMS) as ex:
                futs = [ex.submit(tr.stream, "direct_concurrent",
                                  urls[picked[j]], body(prompts[j]),
                                  tr.header("direct_concurrent"))
                        for j in order]
                for f in futs:
                    f.result()
            for j, n in enumerate(nodes):
                for r in n.seen[marks[j]:]:
                    i = prompts.index(list(r.prompt_ids))
                    if list(r.output_ids) != streams[i]:
                        fail(f"router: direct concurrent: prompt {i} gave "
                             f"other tokens than through the routers")
            log(f"[router] async: {ROUTER_ASYNC_STREAMS} concurrent SSE "
                f"streams through AsyncRouterServer over the 4 prompts, "
                f"each on its prompt's replica with the threaded router's "
                f"tokens; the same {ROUTER_ASYNC_STREAMS} sent directly give "
                f"them too")
            # 4. failover
            f_idx = picked[0]
            before = router.stats
            nodes[f_idx].stop()
            marks = [len(n.seen) for n in nodes]
            for what in ("first", "second"):
                _completion(*_post_h(base, body(prompts[0])), 32,
                            f"router: failover, {what}")
            served = nodes[1 - f_idx].seen[marks[1 - f_idx]:]
            after = router.stats
            status, _, raw = _http(base + "/health")
            health = json.loads(raw)
            down = [b["url"] for b in health["backends"]
                    if not b["healthy"]]
            delta = {key: after[key] - before[key] for key in after
                     if after[key] != before[key]}
            if len(served) != 2 or any(list(r.output_ids) != streams[0]
                                       for r in served):
                fail(f"router: failover: {len(served)} requests served by "
                     f"the other replica, or a stream differs")
            if down != [urls[f_idx]] or status != 200 or \
                    delta.get("retries_total") != 1 or \
                    delta.get("no_backend_total") or \
                    delta.get("requests_total") != 2:
                fail(f"router: failover: /health {status} down {down}, "
                     f"counter deltas {delta}")
            out["failover"] = delta
            log(f"[router] failover: replica {f_idx} stopped; its prompt "
                f"served twice by replica {1 - f_idx} with the same tokens; "
                f"/health shows it down; counter deltas {delta}")
            torch.cuda.synchronize()
            launches = dict(flash.LAUNCHES)
        finally:
            if ars is not None:
                ars.stop()
            rs.stop()
            for n in nodes:
                n.stop()
        for name in ("flash_decode", "flash_prefill"):
            if launches[name] <= 0:
                fail(f"router: {name} was never launched ({launches})")
        med = {kind: tr.medians(nodes, kind)
               for kind in ("direct", "threaded", "direct_concurrent",
                            "async")}
        out.update(launches=launches, medians=med,
                   async_routed=len(_routed_records(alog)))
    for k, m in med.items():
        log(f"[router] {k}: TTFT median {m['ttft_s'] * 1e3:.2f} ms, TPOT "
            f"median {m['tpot_s'] * 1e3:.2f} ms (replicas' request logs), "
            f"client's time less the replica's e2e {m['added_s'] * 1e3:.2f}"
            f" ms, median over {m['n']} prefix-hit streams")
    log(f"[router] launches {launches}")
    return out


# -- phases 29-31: multi-LoRA and embeddings ----------------------------------


LORA_RANK = 16
LORA_ALPHA = 32.0
# A and B of the seeded adapters: N(0, 0.035) each, so that the merged
# delta (alpha / r) B A has a std of about 0.01 beside the init's 0.02
LORA_STD = 0.035
LORA_TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
                "up_proj", "down_proj")
# fp32: the factored delta (x A^T) B against the merged W + (alpha/r) B A
LORA_MERGED_ATOL = 2e-3
# intfloat/e5-mistral-7b-instruct config.json (MistralModel)
E5_MISTRAL_7B = {"_source": "intfloat/e5-mistral-7b-instruct config.json",
                 "architectures": ["MistralModel"], "model_type": "mistral",
                 "vocab_size": 32000, "hidden_size": 4096,
                 "num_hidden_layers": 32, "num_attention_heads": 32,
                 "num_key_value_heads": 8, "intermediate_size": 14336,
                 "rope_theta": 10000.0, "rms_norm_eps": 1e-5,
                 "sliding_window": 4096, "max_position_embeddings": 32768,
                 "tie_word_embeddings": False}
# the window every embedding batch's B2 launches take (kernels phase)
EMBED_WINDOW = E5_MISTRAL_7B["sliding_window"]
# bf16: an input embedded alone against itself in its bucket's batch
EMBED_COS_MIN = 0.999
# fp32, 4 layers: the same, as max abs diff of unit vectors
EMBED_FP32_ATOL = 1e-4


def _write_adapter(torch, path: str, cfg, seed: int, dtype=None) -> str:
    """A PEFT adapter dir over every target of every layer of `cfg`:
    lora_A [r, in] / lora_B [out, r] drawn N(0, LORA_STD) from `seed`
    (a CPU generator), written with the port's `save_safetensors` in
    `dtype` (default float32)."""
    from ome_tpu_torch.models.checkpoint import save_safetensors
    os.makedirs(path, exist_ok=True)
    gen = torch.Generator().manual_seed(seed)
    D, H, K, Dh, F = (cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads,
                      cfg.head_dim, cfg.intermediate_size)
    shapes = {"q_proj": (H * Dh, D), "k_proj": (K * Dh, D),
              "v_proj": (K * Dh, D), "o_proj": (D, H * Dh),
              "gate_proj": (F, D), "up_proj": (F, D), "down_proj": (D, F)}
    tensors = {}
    for layer in range(cfg.num_layers):
        for m in LORA_TARGETS:
            out, inp = shapes[m]
            part = "self_attn" if m in LORA_TARGETS[:4] else "mlp"
            pre = f"base_model.model.model.layers.{layer}.{part}.{m}."
            for ab, shape in (("A", (LORA_RANK, inp)),
                              ("B", (out, LORA_RANK))):
                t = torch.randn(shape, generator=gen).mul_(LORA_STD)
                tensors[pre + f"lora_{ab}.weight"] = t.to(
                    dtype or torch.float32)
    save_safetensors(os.path.join(path, "adapter_model.safetensors"),
                     tensors)
    with open(os.path.join(path, "adapter_config.json"), "w") as f:
        json.dump({"r": LORA_RANK, "lora_alpha": LORA_ALPHA,
                   "target_modules": list(LORA_TARGETS)}, f)
    return path


def phase_lora_identity(torch, seed: int = 0, n_layers: int = 4,
                        steps: int = 24):
    """fp32 at the Llama-3-8B widths, `n_layers` deep, three seeded PEFT
    adapters (rank 16, alpha 32, all seven targets) in 4 LoRA slots:
    (a) base, a1, a2 and a3 in one decode batch, each stream identical
    to the same request alone, and each adapter's stream differing from
    the base's; (b) each adapter against an engine over its
    `merge_lora` weights: the first decode step's logits within
    LORA_MERGED_ATOL and identical greedy streams; (c) the dense (B1)
    and the fp32 paged (B3) engines give identical streams under
    adapters; (d) `decode_multi` K=4 and the scheduler at spec 4, K 4
    (B2 at Sq 5 for the verify) give the single-step streams under
    adapters, on phase 12's tied and scaled weights and base prompts
    (whose greedy streams the drafter predicts) beside four adapter
    requests in 8 slots; (e) unregister is refused while a1
    decodes, then a1 is unregistered and registered again by name from
    a2's directory, and decodes as a2."""
    import random
    import tempfile

    from ome_tpu_torch.engine.core import InferenceEngine
    from ome_tpu_torch.models.config import llama3_8b
    from ome_tpu_torch.models.lora import merge_lora
    from ome_tpu_torch.models.params import init_params
    from ome_tpu_torch.ops import flash

    cfg = llama3_8b().replace(num_layers=n_layers, dtype=torch.float32)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    params = init_params(cfg, gen, torch.device("cuda"))
    rng = random.Random(seed + 29)
    bases = [[rng.randrange(3, cfg.vocab_size) for _ in range(n)]
             for n in (37, 200, 515, 1000)]
    names = ("a1", "a2", "a3")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        dirs = {name: _write_adapter(torch, os.path.join(tmp, name), cfg,
                                     seed + 100 + i)
                for i, name in enumerate(names)}
        kw = dict(max_slots=4, max_seq=2048, device="cuda", seed=seed,
                  lora_slots=4, lora_rank=LORA_RANK)
        eng = InferenceEngine(params, cfg, **kw)
        for name in names:
            eng.register_adapter(name, dirs[name])
        ads = (None,) + names
        flash.reset_launches()

        def min_gap(gaps, n):
            return min(float(g[:n].min()) for g in gaps)
        # (a) the mixed batch against each request alone
        batch, gaps, first = _greedy_streams(torch, eng, bases, steps, ads)
        gap = min_gap(gaps, len(bases))
        for i, (ids, ad) in enumerate(zip(bases, ads)):
            alone, gaps, _ = _greedy_streams(torch, eng, [ids], steps, [ad])
            gap = min(gap, min_gap(gaps, 1))
            if alone[0] != batch[i]:
                fail(f"multi-LoRA (a): {ad or 'base'} in the batch differs "
                     f"from its request alone")
            if ad and _greedy_streams(torch, eng, [ids], steps)[0][0] \
                    == batch[i]:
                fail(f"multi-LoRA: {ad}'s stream equals the base model's "
                     f"for the same prompt")
        log(f"[lora] (a) fp32, Llama-3-8B widths, {n_layers} layers, "
            f"rank {LORA_RANK}, alpha {LORA_ALPHA}: base, a1, a2, a3 in one "
            f"batch give each request's stream alone ({steps} tokens, "
            f"prompts {[len(b) for b in bases]}; smallest top-2 gap "
            f"{gap:.3e}); every adapter's stream differs from the base's")
        # (b) against merge_lora engines
        merged_err = {}
        for i, name in enumerate(names, 1):
            layers = {k: v.clone() for k, v in params["layers"].items()}
            tree = dict(params, layers=layers)
            merge_lora(tree, cfg, dirs[name])
            m_eng = InferenceEngine(tree, cfg, **dict(kw, lora_slots=0))
            m_streams, m_gaps, m_first = _greedy_streams(
                torch, m_eng, [bases[i]], steps)
            err = float((m_first[0] - first[i]).abs().max())
            merged_err[name] = err
            if err > LORA_MERGED_ATOL or m_streams[0] != batch[i]:
                fail(f"multi-LoRA (b): {name} against its merged engine: "
                     f"first-step logits max abs diff {err:.3e} (tolerance "
                     f"{LORA_MERGED_ATOL}), streams identical "
                     f"{m_streams[0] == batch[i]} (smallest top-2 gap "
                     f"{min_gap(m_gaps, 1):.3e})")
            del m_eng, tree, layers
        log(f"[lora] (b) each adapter against its merge_lora engine: "
            f"first-step logits max abs diff "
            f"{ {k: float(f'{v:.3e}') for k, v in merged_err.items()} } "
            f"(fp32 tolerance {LORA_MERGED_ATOL}), greedy streams identical")
        # (c) dense against paged
        p_eng = InferenceEngine(params, cfg, **kw, kv_block=128)
        for name in names:
            p_eng.register_adapter(name, dirs[name])
        if _greedy_streams(torch, p_eng, bases, steps, ads)[0] != batch:
            fail("multi-LoRA (c): dense and paged fp32 streams differ "
                 "under adapters")
        if not p_eng.kv_conservation()[0]:
            fail("multi-LoRA (c): the pool is not conserved")
        log("[lora] (c) dense (flash_decode) = paged fp32 pool "
            "(flash_paged_decode) streams under adapters")
        # (e) unregister in flight, then re-register by name
        state, _ = _admit(eng, [bases[1]], ["a1"])
        try:
            eng.unregister_adapter("a1")
            fail("multi-LoRA (e): unregister of an in-flight adapter was "
                 "not refused")
        except ValueError as e:
            refused = str(e)
        eng.free_slot(0)
        eng.unregister_adapter("a1")
        eng.register_adapter("a1", dirs["a2"])
        again = _greedy_streams(torch, eng, [bases[2]], steps, ["a1"])[0]
        if again[0] != batch[2]:
            fail("multi-LoRA (e): a1 re-registered from a2's directory "
                 "does not decode as a2")
        log(f"[lora] (e) unregister while in flight refused ({refused!r}); "
            f"unregistered, re-registered a1 from a2's directory: decodes "
            f"as a2")
        del eng, p_eng, params, state
        # (d) the step plans, on phase 12's weights and base prompts
        # (tied embeddings scaled by EMBED_SCALE: their greedy streams
        # repeat n-grams, so the drafter proposes), beside four adapter
        # requests that ride every verify forward
        tcfg = cfg.replace(tie_word_embeddings=True)
        gen.manual_seed(seed)
        tied = init_params(tcfg, gen, torch.device("cuda"))
        tied["embed"].mul_(EMBED_SCALE)
        rng3 = random.Random(seed + 3)
        prompts = [[rng3.randrange(3, cfg.vocab_size) for _ in range(n)]
                   for n in (20, 75, 150, 300)]
        prompts += [[rng.randrange(3, cfg.vocab_size) for _ in range(n)]
                    for n in (30, 90, 180, 260)]
        plan_ads = [None] * 4 + list(names) + ["a1"]
        plan_steps = 40
        plan_streams = {}
        for pool, pkw in (("dense", {}), ("paged", {"kv_block": 128})):
            p_eng = InferenceEngine(tied, tcfg, **dict(kw, max_slots=8),
                                    **pkw)
            for name in names:
                p_eng.register_adapter(name, dirs[name])
            single = _greedy_streams(torch, p_eng, prompts, plan_steps,
                                     plan_ads)[0]
            multi = _multi_streams(torch, p_eng, prompts, plan_steps, 4,
                                   plan_ads)
            planned, sched = _sched_streams(
                p_eng, prompts, plan_steps, plan_ads, pipeline_depth=1,
                spec_tokens=4, steps_per_dispatch=4)
            if multi != single or planned != single:
                fail(f"multi-LoRA (d) {pool}: decode_multi identical "
                     f"{multi == single}, scheduler spec 4 K 4 identical "
                     f"{planned == single}")
            plan_streams[pool] = single
            st = sched.stats
            out[f"plans_{pool}"] = {
                "spec_steps": st["spec_steps_total"],
                "spec_proposed": st["spec_proposed_tokens_total"],
                "spec_accepted": st["spec_accepted_tokens_total"]}
            if st["spec_steps_total"] <= 0:
                fail(f"multi-LoRA (d) {pool}: no verify step ran "
                     f"({out[f'plans_{pool}']})")
            if pool == "paged" and not p_eng.kv_conservation()[0]:
                fail("multi-LoRA (d) paged: the pool is not conserved")
            del p_eng, sched
        if plan_streams["dense"] != plan_streams["paged"]:
            fail("multi-LoRA (d): dense and paged streams differ")
        launches = dict(flash.LAUNCHES)
        for name in ("flash_decode", "flash_prefill", "flash_paged_decode"):
            if launches[name] <= 0:
                fail(f"multi-LoRA: {name} was never launched ({launches})")
        log(f"[lora] (d) tied embeddings x {EMBED_SCALE}: decode_multi K=4 "
            f"and the scheduler (spec 4, K 4, depth 1) = single steps under "
            f"adapters, dense and paged: {out['plans_dense']} / "
            f"{out['plans_paged']}; launches {launches}")
        del tied
    out.update({"streams_identical": True, "steps": steps,
                "merged_max_abs_err": merged_err, "launches": launches,
                "min_top2_gap": gap})
    return out


LORA_RANGE = "lora_delta"


def _lora_step_profile(torch, engine, prompt, jobs_adapters):
    """Decode-step wall and device ms, idle share, launches per step and
    the delta's device ms of 8 armed slots at lengths 64-2164, for each
    list of slot adapters in `jobs_adapters` (name -> [adapter or None]
    * 8). The delta is what runs inside `llama.select_adapters` (the
    factor gathers) and `llama._lora_delta` (the batched products): in
    the profiled steps each call is wrapped in a `record_function`
    range, LORA_RANGE, whose device time is the delta's."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from ome_tpu_torch.models import llama

    def ranged(fn):
        def call(*a, **kw):
            with record_function(LORA_RANGE):
                return fn(*a, **kw)
        return call
    dev = torch.device("cuda")
    greedy = (torch.zeros(engine.max_slots, device=dev),
              torch.zeros(engine.max_slots, dtype=torch.int32, device=dev),
              torch.ones(engine.max_slots, device=dev))
    res = {}
    for what, adapters in jobs_adapters.items():
        state = engine.new_state()
        for slot, ad in enumerate(adapters):
            kw = {} if ad is None else {"adapter": ad}
            tok, kv, n, bucket = engine.prefill(prompt(64 + 300 * slot),
                                                **kw)
            state = engine.insert(state, kv, slot, n, tok, bucket, **kw)
        box = [state]

        def decode():
            box[0], toks = engine.decode(box[0], *greedy)
            np.asarray(toks)
        decode()
        torch.cuda.synchronize()
        times = []
        for _ in range(10):
            t = time.perf_counter()
            decode()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        wall = statistics.median(times)
        iters = 3
        plain = llama.select_adapters, llama._lora_delta
        llama.select_adapters, llama._lora_delta = map(ranged, plain)
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    decode()
                torch.cuda.synchronize()
        finally:
            llama.select_adapters, llama._lora_delta = plain
        busy = launches = delta = 0.0
        for ev in prof.key_averages():
            if ev.key == LORA_RANGE:
                # the host-side range: the device time of the kernels
                # launched inside it (its device-side twin, the range's
                # span on the card, is left out of the busy time)
                if ev.device_type != DeviceType.CUDA:
                    us = getattr(ev, "device_time_total", None)
                    if us is None:
                        us = getattr(ev, "cuda_time_total", 0)
                    delta += us / iters / 1e3
            elif ev.device_type == DeviceType.CUDA:
                us = getattr(ev, "self_device_time_total", None)
                if us is None:
                    us = getattr(ev, "self_cuda_time_total", 0)
                busy += us / iters / 1e3
                launches += ev.count / iters
        for slot in range(len(adapters)):
            engine.free_slot(slot)
        res[what] = {"wall_ms": wall, "device_ms": busy or None,
                     "idle_share": 1 - busy / wall if busy else None,
                     "launches_per_step": launches,
                     "delta_device_ms": delta}
        if not busy:
            fail(f"[lora server] {what}: the profiler saw no device time")
        if any(adapters) and not delta:
            fail(f"[lora server] {what}: no device time inside the "
                 f"{LORA_RANGE} ranges with adapters in the batch")
        log(f"[lora server] decode step, 8 slots, {what}: wall {wall:.2f} "
            f"ms, device busy {busy:.2f} ms, idle share "
            f"{1 - busy / wall:.2f}, {launches:.0f} device launches per "
            f"step, LoRA delta (select_adapters + _lora_delta ranges) "
            f"{delta:.3f} ms device")
    return res


def phase_lora_server(torch, seed: int = 0):
    """The bf16 Llama-3-8B-width server (`CUT_LAYERS` deep) with three
    named adapters (rank 16, alpha 32, all seven targets, seeded bf16 factors) in 4
    slots, through `serve.build_server`: 12 concurrent requests (4 base,
    8 across the adapters); a4 registered with `POST /v1/adapters` while
    requests decode, then a request to it; `DELETE /v1/adapters/a1`
    while an a1 request decodes gives 409 and, once it finished, 200;
    the same 12 prompts to the base model for the TTFT/TPOT medians
    beside the mixed ones; then decode steps of 8 slots with and without
    adapters in the batch."""
    import concurrent.futures
    import random
    import tempfile
    import urllib.error
    import urllib.request

    from ome_tpu_torch.engine import serve
    from ome_tpu_torch.models.config import llama3_8b
    from ome_tpu_torch.ops import flash

    cfg = llama3_8b().replace(num_layers=CUT_LAYERS)
    hf = _hf_config(cfg)
    rng = random.Random(seed + 30)
    tag = "[lora server]"

    def prompt(n):
        return [rng.randrange(3, cfg.vocab_size) for _ in range(n)]

    def call(url, path, body=None, method=None):
        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(url + path, data=data, method=method,
                                     headers={"Content-Type":
                                              "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=600) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "config.json"), "w") as f:
            json.dump(hf, f)
        t0 = time.monotonic()
        dirs = {a: _write_adapter(torch, os.path.join(tmp, a), cfg,
                                  seed + 300 + i, dtype=torch.bfloat16)
                for i, a in enumerate(("a1", "a2", "a3", "a4"))}
        out["adapter_write_s"] = time.monotonic() - t0
        reqlog = os.path.join(tmp, "requests.jsonl")
        t0 = time.monotonic()
        server, sched, engine = serve.build_server(
            ["--model-dir", tmp, "--random-weights", "--seed", str(seed),
             "--max-slots", "16", "--max-seq", "4096", "--port", "0",
             "--host", "127.0.0.1", "--request-log", reqlog,
             "--adapter", f"a1={dirs['a1']}", "--adapter",
             f"a2={dirs['a2']}", "--adapter", f"a3={dirs['a3']}",
             "--lora-slots", "4", "--lora-rank", str(LORA_RANK)])
        torch.cuda.synchronize()
        out["startup_s"] = time.monotonic() - t0
        stack_bytes = sum(t.numel() * t.element_size()
                          for t in engine._lora.values())
        out["adapter_stack_bytes"] = stack_bytes
        log(f"{tag} Llama-3-8B, random bf16 weights (seed {seed}), "
            f"{cfg.num_layers} layers, slots 16, adapters "
            f"{engine.adapter_names} in {engine.lora_slots} slots of rank "
            f"{engine.lora_rank}: server up in {out['startup_s']:.1f} s; "
            f"adapter stacks {stack_bytes / 1e6:.1f} MB on the device")
        url = f"http://127.0.0.1:{server.port}"
        try:
            lengths = [16, 100, 250, 400, 600, 800, 1000, 1300, 1600, 2000,
                       2400, 3000]
            prompts = [prompt(n) for n in lengths]
            models = ["base"] * 4 + ["a1", "a2", "a3"] * 2 + ["a1", "a2"]
            rng.shuffle(models)
            flash.reset_launches()

            base_id = server.model_name

            def send(model, p, n=32):
                return call(url, "/v1/completions", {
                    "model": base_id if model == "base" else model,
                    "prompt": p, "max_tokens": n, "temperature": 0.0})
            t_mixed = time.monotonic()
            with concurrent.futures.ThreadPoolExecutor(12) as ex:
                futs = [ex.submit(send, m, p) for m, p in
                        zip(models, prompts)]
                docs = [f.result() for f in futs]
            out["mixed_s"] = time.monotonic() - t_mixed
            for i, (status, doc) in enumerate(docs):
                if status != 200:
                    fail(f"{tag} mixed request {i} ({models[i]}): HTTP "
                         f"{status} {doc}")
            texts = {}
            for m, (_, doc) in zip(models, docs):
                texts.setdefault(m, set()).add(doc["choices"][0]["text"])
            log(f"{tag} 12 concurrent requests (4 base, 8 across a1-a3, "
                f"prompts {lengths}): all 200 in {out['mixed_s']:.2f} s")
            # a4 registered while requests decode, then a request to it
            with concurrent.futures.ThreadPoolExecutor(4) as ex:
                futs = [ex.submit(send, m, p, 48) for m, p in
                        zip(("base", "a2", "a3", "base"), prompts[4:8])]
                time.sleep(0.5)
                status, doc = call(url, "/v1/adapters",
                                   {"name": "a4", "path": dirs["a4"]})
                if status != 200 or doc.get("name") != "a4":
                    fail(f"{tag} POST /v1/adapters a4: HTTP {status} {doc}")
                for f in futs:
                    if f.result()[0] != 200:
                        fail(f"{tag} a request beside the a4 register "
                             f"failed: {f.result()}")
            status, doc = send("a4", prompts[0])
            if status != 200:
                fail(f"{tag} the a4 request: HTTP {status} {doc}")
            status, listed = call(url, "/v1/models")
            ids = [m["id"] for m in listed["data"]]
            if ids[1:] != ["a1", "a2", "a3", "a4"]:
                fail(f"{tag} /v1/models lists {ids}")
            log(f"{tag} POST /v1/adapters a4 while 4 requests decoded: "
                f"slot {engine.adapter_id('a4')}; a4 answered; /v1/models "
                f"{ids}")
            # DELETE a1 while an a1 request decodes, then after it
            aid = engine.adapter_id("a1")
            with concurrent.futures.ThreadPoolExecutor(1) as ex:
                fut = ex.submit(send, "a1", prompts[3], 64)
                t_wait = time.monotonic()
                while not (engine._slot_adapters == aid).any():
                    if fut.done() or time.monotonic() - t_wait > 120:
                        fail(f"{tag} the a1 request never decoded")
                    time.sleep(0.002)
                busy = call(url, "/v1/adapters/a1", method="DELETE")
                done = fut.result()
            if busy[0] != 409 or busy[1].get("retryable") is not True:
                fail(f"{tag} DELETE a1 while in flight: {busy}")
            if done[0] != 200:
                fail(f"{tag} the in-flight a1 request: {done}")
            t_wait = time.monotonic()
            while (engine._slot_adapters == aid).any():
                if time.monotonic() - t_wait > 60:
                    fail(f"{tag} the finished a1 request kept its slot")
                time.sleep(0.002)
            gone = call(url, "/v1/adapters/a1", method="DELETE")
            if gone != (200, {"removed": "a1"}):
                fail(f"{tag} DELETE a1 after it finished: {gone}")
            log(f"{tag} DELETE /v1/adapters/a1 while an a1 request decoded: "
                f"{busy[0]} retryable; after it finished: {gone[0]}; "
                f"adapters now {engine.adapter_names}")
            # the same 12 prompts to the base model
            t_base = time.monotonic()
            with concurrent.futures.ThreadPoolExecutor(12) as ex:
                base_docs = list(ex.map(lambda p: send("base", p), prompts))
            out["base_s"] = time.monotonic() - t_base
            if any(s != 200 for s, _ in base_docs):
                fail(f"{tag} a base-only request failed")
            torch.cuda.synchronize()
            launches = dict(flash.LAUNCHES)
        finally:
            server.stop()
        with open(reqlog) as f:
            recs = [json.loads(line) for line in f]
        mixed = recs[:12]
        base = recs[-12:]
        out["mixed_ttft_s"], out["mixed_tpot_s"] = _medians(mixed)
        out["base_ttft_s"], out["base_tpot_s"] = _medians(base)
        log(f"{tag} TTFT / TPOT medians: mixed (4 base + 8 adapter) "
            f"{out['mixed_ttft_s'] * 1e3:.1f} ms / "
            f"{out['mixed_tpot_s'] * 1e3:.2f} ms; the same 12 prompts to "
            f"the base model {out['base_ttft_s'] * 1e3:.1f} ms / "
            f"{out['base_tpot_s'] * 1e3:.2f} ms")
        engine.register_adapter("a1", dirs["a1"])
        out["step"] = _lora_step_profile(torch, engine, prompt, {
            "base only": [None] * 8,
            "adapters in the batch (2 base, a1-a4 x 1-2)":
                [None, "a1", "a2", "a3", "a4", None, "a1", "a2"]})
    out["launches"] = launches
    for k in ("flash_decode", "flash_prefill"):
        if launches[k] <= 0:
            fail(f"{tag} kernel {k} was never launched while serving")
    log(f"{tag} kernel launches while serving: {launches}")
    return out


def phase_embed(torch, timeout: float = 900):
    """Phase 31 in a child process (`embed_measure`) started with
    cuBLAS's workspace off, as `serve`'s main starts `--task embed`:
    cuBLAS reads CUBLAS_WORKSPACE_CONFIG at a process's first product,
    and this process has run many. The child prints its own lines and
    writes its results to chiprun_out/embed_phase.json."""
    from ome_tpu_torch.engine import serve
    path = os.path.join(OUT_DIR, "embed_phase.json")
    os.makedirs(OUT_DIR, exist_ok=True)
    if os.path.exists(path):
        os.remove(path)
    env = dict(os.environ,
               CUBLAS_WORKSPACE_CONFIG=serve.EMBED_CUBLAS_WORKSPACE)
    root = os.path.dirname(os.path.abspath(__file__))
    try:
        proc = subprocess.run(
            [sys.executable, "-c",
             "import sys, torch, chip_smoke as c; "
             "c.phase_device(torch); sys.exit(c.embed_measure(torch))"],
            cwd=root, env=env, timeout=timeout)
    except subprocess.TimeoutExpired:
        fail(f"[embed] the embedding phase's process ran past {timeout} s")
    if proc.returncode != 0 or not os.path.exists(path):
        fail(f"[embed] the embedding phase's process exited "
             f"{proc.returncode}")
    with open(path) as f:
        return json.load(f)


def embed_measure(torch, seed: int = 0, n_inputs: int = 48) -> int:
    """Decoder embeddings at e5-mistral-7b-instruct's widths, `CUT_LAYERS`
    of its 32 layers, in bf16
    (random weights from the seed), through `serve --task embed`:
    `/v1/embeddings` answers 8 inputs and `/v1/completions` is refused
    with the reference's error; then the EmbeddingEngine over 48 inputs
    of 16-6000 tokens across its five buckets, one forward per bucket
    (B2 at batch N per layer): batch size, tokens/s, embeddings/s,
    device ms and idle share, B2 launches per bucket; every embedding of
    norm 1, and each input embedded alone within cosine EMBED_COS_MIN of
    itself in its batch. At 4 fp32 layers of the same widths, alone and
    batched agree within EMBED_FP32_ATOL. Run first in its process (see
    `phase_embed`); writes chiprun_out/embed_phase.json, returns 0."""
    import random
    import tempfile
    import urllib.error
    import urllib.request

    import numpy as np

    from ome_tpu_torch.engine import serve
    from ome_tpu_torch.engine.embed import EmbeddingEngine
    from ome_tpu_torch.models.config import ModelConfig
    from ome_tpu_torch.models.params import init_params
    from ome_tpu_torch.ops import flash

    hf = {k: v for k, v in E5_MISTRAL_7B.items() if k != "_source"}
    hf["num_hidden_layers"] = CUT_LAYERS  # time budget: 8 of its 32
    rng = random.Random(seed + 31)
    tag = "[embed]"

    def post(url, path, body):
        req = urllib.request.Request(
            url + path, data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=600) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    # 48 inputs across the buckets 32, 128, 512, 2048 and 8192
    spans = ((16, 32, 10), (33, 128, 10), (129, 512, 10), (513, 2048, 10),
             (2049, 6000, n_inputs - 40))
    inputs = [[rng.randrange(3, hf["vocab_size"])
               for _ in range(rng.randint(lo, hi))]
              for lo, hi, k in spans for _ in range(k)]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "config.json"), "w") as f:
            json.dump(hf, f)
        argv = ["--model-dir", tmp, "--random-weights", "--seed",
                str(seed), "--task", "embed", "--max-seq", "8192",
                "--port", "0", "--host", "127.0.0.1"]
        # without cuBLAS's workspace off, the server refuses to start
        ws = os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        refused = None
        try:
            serve.build_server(argv)
        except SystemExit as e:
            refused = str(e.code)
        finally:
            if ws is not None:
                os.environ["CUBLAS_WORKSPACE_CONFIG"] = ws
        if refused is None or "CUBLAS_WORKSPACE_CONFIG" not in refused:
            fail(f"{tag} serve --task embed without cuBLAS's workspace "
                 f"off: {refused or 'started'}")
        t0 = time.monotonic()
        server, _, emb = serve.build_server(argv)
        torch.cuda.synchronize()
        out["startup_s"] = time.monotonic() - t0
        if not isinstance(emb, EmbeddingEngine):
            fail(f"{tag} serve --task embed built {type(emb).__name__}")
        weight_bytes = sum(t.numel() * t.element_size()
                           for t in emb.model.buffers())
        log(f"{tag} e5-mistral-7b-instruct widths ({emb.cfg.num_layers} "
            f"layers, window {emb.cfg.sliding_window}), random bf16 weights "
            f"(seed {seed}) {weight_bytes / 1e9:.2f} GB: serve --task embed "
            f"up in {out['startup_s']:.1f} s; buckets {emb.buckets}")
        url = f"http://127.0.0.1:{server.port}"
        try:
            status, doc = post(url, "/v1/embeddings",
                               {"model": "e5", "input": inputs[::6]})
            if status != 200 or len(doc["data"]) != 8 or any(
                    len(d["embedding"]) != hf["hidden_size"]
                    for d in doc["data"]):
                fail(f"{tag} /v1/embeddings: HTTP {status}")
            refused = post(url, "/v1/completions", {"prompt": [1, 2, 3]})
            if refused != (503, {"error": "this deployment serves "
                                          "embeddings only"}):
                fail(f"{tag} /v1/completions on the embeddings "
                     f"deployment: {refused}")
            log(f"{tag} /v1/embeddings: 8 inputs, 200, {hf['hidden_size']} "
                f"dims each, {doc['usage']['prompt_tokens']} tokens; "
                f"/v1/completions refused: {refused[0]} {refused[1]}")
        finally:
            server.stop()
        groups = {}
        for i, ids in enumerate(inputs):
            groups.setdefault(emb.bucket_of(len(ids)), []).append(i)
        batched = np.zeros((len(inputs), hf["hidden_size"]), np.float32)
        per_bucket = {}
        for bucket in sorted(groups):
            idx = groups[bucket]
            rows = [inputs[i] for i in idx]

            def run():
                return emb.embed(rows)
            run()
            torch.cuda.synchronize()
            flash.reset_launches()
            t = time.perf_counter()
            got = run()
            wall = (time.perf_counter() - t) * 1e3
            b2 = flash.LAUNCHES["flash_prefill"]
            busy, top, _, _ = _device_profile(torch, run, 1)
            batched[idx] = got
            ntok = sum(len(r) for r in rows)
            per_bucket[bucket] = {
                "batch": len(rows), "tokens": ntok, "wall_ms": wall,
                "device_ms": busy or None,
                "idle_share": 1 - busy / wall if busy else None,
                "tokens_per_s": ntok / wall * 1e3,
                "embeddings_per_s": len(rows) / wall * 1e3,
                "flash_prefill_launches": b2, "top": top}
            if b2 != emb.cfg.num_layers:
                fail(f"{tag} bucket {bucket}: {b2} flash_prefill launches "
                     f"for one batch of {emb.cfg.num_layers} layers")
            log(f"{tag} bucket {bucket}: batch {len(rows)}, {ntok} tokens, "
                f"wall {wall:.1f} ms, device busy {busy:.1f} ms, idle share "
                f"{1 - busy / wall:.2f}, {ntok / wall * 1e3:.0f} tokens/s, "
                f"{len(rows) / wall * 1e3:.2f} embeddings/s, flash_prefill "
                f"launches {b2}")
        norms = np.linalg.norm(batched, axis=-1)
        if np.abs(norms - 1).max() > 1e-3:
            fail(f"{tag} embedding norms {norms.min()}..{norms.max()}")
        alone = np.stack([emb.embed([ids])[0] for ids in inputs])
        cos = (alone * batched).sum(-1) / (
            np.linalg.norm(alone, axis=-1) * norms)
        cos_by_bucket = {b: float(cos[idx].min())
                         for b, idx in sorted(groups.items())}
        alone_err = float(np.abs(alone - batched).max())
        log(f"{tag} {len(inputs)} embeddings of norm 1 (max |norm - 1| "
            f"{np.abs(norms - 1).max():.2e}); each alone against itself "
            f"in its batch, cosine min by bucket {cos_by_bucket} (bf16, "
            f">= {EMBED_COS_MIN}), max abs diff {alone_err:.3e}")
        out.update({"buckets": per_bucket, "cos_min": float(cos.min()),
                    "cos_min_by_bucket": cos_by_bucket,
                    "alone_max_abs_err": alone_err,
                    "norm_err_max": float(np.abs(norms - 1).max())})
        del emb, server
    _free_device(torch, "the e5-mistral embedder")
    # 4 fp32 layers of the same widths: alone against batched
    cfg = ModelConfig.from_hf_config(hf).replace(num_layers=4,
                                                 dtype=torch.float32)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    small = EmbeddingEngine(init_params(cfg, gen, torch.device("cuda")), cfg,
                            max_seq=8192, device="cuda")
    pick = [inputs[i] for i in (0, 1, 10, 11, 20, 21, 30, 31, 40, 41)]
    got = small.embed(pick)
    one = np.stack([small.embed([ids])[0] for ids in pick])
    err = float(np.abs(got - one).max())
    if err > EMBED_FP32_ATOL:
        fail(f"{tag} fp32, 4 layers: alone against batched max abs diff "
             f"{err:.3e} > {EMBED_FP32_ATOL}")
    log(f"{tag} fp32, 4 layers, two inputs per bucket: alone against "
        f"batched max abs diff {err:.3e} (tolerance {EMBED_FP32_ATOL})")
    out["fp32_alone_max_abs_err"] = err
    if out["cos_min"] < EMBED_COS_MIN:
        fail(f"{tag} an input alone against itself in its batch: cosine "
             f"{out['cos_min']:.5f} < {EMBED_COS_MIN}")
    with open(os.path.join(OUT_DIR, "embed_phase.json"), "w") as f:
        json.dump(out, f, indent=1)
    return 0


def embed_invariance(torch, seed: int = 0):
    """Batch invariance of bf16 embeddings under this process's cuBLAS
    workspace (CUBLAS_WORKSPACE_CONFIG, which cuBLAS reads at the
    process's first product; `serve --task embed` sets :0:0): at
    e5-mistral-7b-instruct's widths, 8 and 32 layers of seeded random
    weights, 10 inputs of 16-32 and of 2049-6000 tokens each embedded
    alone against itself in its bucket's batch (cosine min, max abs
    diff), and at 32 layers each batch's wall and device ms (the 32 and
    8192 buckets of phase 31); then the Llama-3-8B dense engine's decode
    step and cold 2048-token prefill (device ms). Not part of `main`:
    run it in two processes, the variable unset and set to :0:0, to
    compare."""
    import random

    import numpy as np

    from ome_tpu_torch.engine.core import InferenceEngine
    from ome_tpu_torch.engine.embed import EmbeddingEngine
    from ome_tpu_torch.models.config import ModelConfig, llama3_8b
    from ome_tpu_torch.models.params import init_params

    ws = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    tag = f"[invariance CUBLAS_WORKSPACE_CONFIG={ws}]"
    hf = {k: v for k, v in E5_MISTRAL_7B.items() if k != "_source"}
    rng = random.Random(seed + 5)
    spans = [[[rng.randrange(3, hf["vocab_size"])
               for _ in range(rng.randint(lo, hi))] for _ in range(10)]
             for lo, hi in ((16, 32), (2049, 6000))]
    out = {"workspace": ws}
    for layers in (8, 32):
        cfg = ModelConfig.from_hf_config(hf).replace(
            num_layers=layers, dtype=torch.bfloat16)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        eng = EmbeddingEngine(init_params(cfg, gen, torch.device("cuda")),
                              cfg, max_seq=8192, device="cuda")
        for ins in spans:
            batched = eng.embed(ins)
            alone = np.stack([eng.embed([x])[0] for x in ins])
            cos = (alone * batched).sum(-1) / (
                np.linalg.norm(alone, axis=-1)
                * np.linalg.norm(batched, axis=-1))
            key = f"{layers} layers, {min(map(len, ins))}-" \
                  f"{max(map(len, ins))} tokens"
            out[key] = {"cos_min": float(cos.min()),
                        "max_abs": float(np.abs(alone - batched).max())}
            log(f"{tag} {key}: cosine min {cos.min():.6f}, max abs diff "
                f"{np.abs(alone - batched).max():.3e}")
            if layers == 32:
                walls = []
                for _ in range(3):
                    t = time.perf_counter()
                    eng.embed(ins)
                    walls.append((time.perf_counter() - t) * 1e3)
                busy, _, _, _ = _device_profile(
                    torch, lambda: eng.embed(ins), 1)
                out[key].update(wall_ms=statistics.median(walls),
                                device_ms=busy)
                log(f"{tag} {key}, bucket {eng.bucket_of(max(map(len, ins)))}"
                    f" batch {len(ins)}: wall {statistics.median(walls):.2f}"
                    f" ms, device {busy:.2f} ms")
        del eng
        _free_device(torch, f"the {layers}-layer embedder")
    cfg = llama3_8b().replace(num_layers=CUT_LAYERS)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    e8 = InferenceEngine(init_params(cfg, gen, torch.device("cuda")), cfg,
                         max_slots=8, max_seq=4096, device="cuda")
    r = random.Random(seed + 1)
    step = _step_times(torch, e8, lambda n: [r.randrange(3, cfg.vocab_size)
                                             for _ in range(n)])
    out["decode_device_ms"] = step["decode"]["device_ms"]
    out["prefill_2048_device_ms"] = step["prefill_2048"]["device_ms"]
    log(f"{tag} Llama-3-8B dense engine: decode step device "
        f"{out['decode_device_ms']:.3f} ms, cold 2048-token prefill device "
        f"{out['prefill_2048_device_ms']:.3f} ms")
    return out


# -- phases 32-37: Gemma 2, command-r, Cohere2, Phi-3.5-MoE, gpt-oss --------


# cache lengths of the phase-32 decode cases: around and past the
# 4096-row window of Gemma-2-9B and command-r7b, up to their 8192
FAMILY_LENGTHS = [64, 300, 1023, 2049, 4095, 4097, 6000, 8192]
NO_SOFTCAP_SDPA = "none: SDPA takes no logit softcap"
NO_SINKS_SDPA = "none: SDPA takes no attention sinks"


def phase_family_kernels(torch):
    """B1 and B2 at the new served argument combinations, each against
    its plain version with the existing tolerances (bf16 2e-2, fp32
    2e-4): Gemma-2-9B's heads (H 16, K 8, D 256) with its scale
    256^-0.5 and softcap 50, B1 in bf16 and fp32 over cache lengths
    64-8192 with its 4096-row window and without, B2 causal 2048 and
    8192 in bf16 with and without the window and in fp32 with it; and B1
    at command-r's G 1 (H = K = 64, D 128), bf16 and fp32; B1 and B2 at
    gpt-oss-20b's heads (H 64, K 8, D 64) with its sink logits, B1 over
    64-8192 rows with its 128-row window and without (bf16, and fp32
    with the window), B2 causal 2048 with and without the window and
    8192 without (bf16; fp32 at 2048 with it); and the card's sink
    attention through `attention` (the kernels) against the reference's
    plain sink attention, `xla_attention`, on the same tensors
    (`_sink_vs_xla`). Each case's ms, bound, share and launches per call
    are printed; a softcapped or sink case has no library time
    (`NO_SOFTCAP_SDPA`, `NO_SINKS_SDPA`)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    timer = Timer(torch, torch.device("cuda"))
    H, K, D = _heads(GEMMA2_9B)
    cap = GEMMA2_9B["attn_logit_softcapping"]
    win = GEMMA2_9B["sliding_window"]
    kw = {"H": H, "K": K, "D": D}
    cases = {"flash_decode": [], "flash_prefill": []}
    for dt in ("bf16", "fp32"):
        for w in (win, None):
            cases["flash_decode"].append(decode_case(
                torch, timer, gen, dt, FAMILY_LENGTHS, window=w,
                softcap=cap, S=8192, **kw))
    for n in (2048, 8192):
        for w in (win, None):
            cases["flash_prefill"].append(prefill_case(
                torch, timer, gen, "bf16", n, n, 0, window=w, softcap=cap,
                **kw))
    cases["flash_prefill"].append(prefill_case(
        torch, timer, gen, "fp32", 2048, 2048, 0, window=win, softcap=cap,
        **kw))
    cr = _heads(COMMAND_R_V01)
    for dt in ("bf16", "fp32"):
        cases["flash_decode"].append(decode_case(
            torch, timer, gen, dt, FAMILY_LENGTHS, S=8192, H=cr[0], K=cr[1],
            D=cr[2]))
    go = _heads(GPT_OSS_20B)
    gw = GPT_OSS_20B["sliding_window"]
    gkw = {"H": go[0], "K": go[1], "D": go[2], "sinks": True}
    for dt, w in (("bf16", gw), ("bf16", None), ("fp32", gw)):
        cases["flash_decode"].append(decode_case(
            torch, timer, gen, dt, FAMILY_LENGTHS, window=w, S=8192,
            check_bits=dt == "bf16", **gkw))
    for dt, n, w in (("bf16", 2048, gw), ("bf16", 2048, None),
                     ("bf16", 8192, None), ("fp32", 2048, gw)):
        cases["flash_prefill"].append(prefill_case(
            torch, timer, gen, dt, n, n, 0, window=w, **gkw))
    # the same shapes without sinks: what the sink costs
    gkw["sinks"] = False
    cases["flash_decode"].append(decode_case(
        torch, timer, gen, "bf16", FAMILY_LENGTHS, S=8192, **gkw))
    cases["flash_prefill"].append(prefill_case(
        torch, timer, gen, "bf16", 2048, 2048, 0, **gkw))
    per_call = {(H, K, D): _launches_per_call(torch, H, K, D),
                cr: _launches_per_call(torch, *cr),
                go: _launches_per_call(torch, *go)}
    for name, rows in cases.items():
        for c in rows:
            shape = next(s for s in per_call
                         if f" H={s[0]} K={s[1]} D={s[2]} " in c["case"])
            c["launches_per_call"] = per_call[shape][name]
            if "softcap=None" not in c["case"]:
                c["library_note"] = NO_SOFTCAP_SDPA
            elif c["case"].endswith(" sinks"):
                c["library_note"] = NO_SINKS_SDPA
            lib = c.get("library_note") or (
                "null" if c["library_ms"] is None
                else f"{c['library_ms']:.4f} ms")
            log(f"[families] {name}: {c['case']}: ms {c['ms']:.4f}, bound "
                f"{c['bound_ms']:.4f} ms ({c['bound_by']}), share "
                f"{c['bound_ms'] / c['ms']:.3f}, plain {c['plain_ms']:.4f} "
                f"ms, library {lib}; {c['launches_per_call']} launch(es) "
                f"per call")
    out = check_cases(cases)
    out["sink_vs_xla"] = _sink_vs_xla(torch, gen, *go, gw)
    return out


def _sink_vs_xla(torch, gen, H, K, D, window):
    """gpt-oss's attention on the card as the model calls it
    (`attention.attention` with sinks, which launches B1 or B2) against
    the reference's plain sink attention (`xla_attention`, a softmax
    over the logits and a sink column, the sink's probability dropped)
    on fp32 copies of the same bf16 tensors with the same mask (so the
    error is the kernels', not the bf16 rounding of two outputs): a
    decode step of 8 sequences over a 4096-row cache and a 1024-token
    causal prefill, each with the 128-row window and without.
    Tolerance: bf16's."""
    from ome_tpu_torch.ops import attention as attn
    from ome_tpu_torch.ops import flash
    dev = torch.device("cuda")
    bf = torch.bfloat16
    sinks = _sink_logits(torch, gen, H)
    errs = {}
    for what, B, Sq, S in (("decode", 8, 1, 4096), ("prefill", 1, 1024,
                                                     1024)):
        q, k, v = _inputs(torch, gen, B, Sq, S, H, K, D, bf, dev)
        if Sq == 1:
            pos = torch.tensor([[n - 1] for n in (1, 50, 127, 129, 1000,
                                                  2049, 4000, 4096)],
                               device=dev)
        else:
            pos = torch.arange(Sq, device=dev)[None]
        kv_len = pos[:, -1] + 1
        for w in (window, None):
            launched = flash.LAUNCHES["flash_decode"] + \
                flash.LAUNCHES["flash_prefill"]
            got = attn.attention(q, k, v, positions=pos, kv_len=kv_len,
                                 sliding_window=w, sinks=sinks)
            if flash.LAUNCHES["flash_decode"] + \
                    flash.LAUNCHES["flash_prefill"] <= launched:
                fail(f"sink attention {what}: no kernel launched")
            kv_pos = torch.arange(S, dtype=torch.int32, device=dev)
            mask = attn.make_causal_mask(pos, kv_pos, kv_len)
            if w:
                mask = mask & (kv_pos[None, None, :] > pos[:, :, None] - w)
            want = attn.xla_attention(q.float(), k.float(), v.float(),
                                      mask=mask, sinks=sinks)
            err = (got.float() - want.float()).abs().max().item()
            errs[f"{what} window={w}"] = err
            if not torch.isfinite(got.float()).all() or \
                    not err <= ATOL["bf16"]:
                fail(f"sink attention {what} window={w}: kernels "
                     f"{err:.3e} from xla_attention (tol {ATOL['bf16']})")
    log(f"[families] gpt-oss sink attention (H {H}, K {K}, D {D}) through "
        f"the kernels against xla_attention, bf16: "
        + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
        + f" (tol {ATOL['bf16']})")
    return errs


FAMILY_MODELS = (("Gemma-2-9B", GEMMA2_9B), ("command-r-v01", COMMAND_R_V01),
                 ("command-r7b", COMMAND_R7B), ("Phi-3.5-MoE", PHI35_MOE),
                 ("gpt-oss-20b", GPT_OSS_20B))


def _seed_family_leaves(torch, params, cfg, seed: int) -> None:
    """Replace the init's zero biases and sinks and its identity norm
    scales with seeded values in place (bf16 or fp32 alike), so that a
    missing or misplaced term shows in the output: q/k/v/o, norm,
    expert and head biases, sinks, gpt-oss's router bias, and norm
    scales around their identity (1, or 0 for Gemma's unit offset)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 91)
    one = 0.0 if cfg.unit_offset_norm else 1.0
    std = {"bq": 0.5, "bk": 0.5, "bv": 0.5, "bo": 0.02, "sinks": 1.0,
           "router_b": 1.0, "we_gate_b": 1.0, "we_up_b": 1.0,
           "we_down_b": 0.02, "lm_head_bias": 0.5}
    leaves = dict(params["layers"])
    leaves.update((n, params[n]) for n in ("final_norm", "final_norm_bias",
                                           "lm_head_bias") if n in params)
    for name, t in leaves.items():
        if name.endswith("_norm_bias"):
            mean, sd = 0.0, 0.1
        elif name.endswith("norm"):
            mean, sd = one, 0.1
        elif name in std:
            mean, sd = 0.0, std[name]
        else:
            continue
        t.copy_(torch.randn(t.shape, generator=gen, device=t.device)
                .mul_(sd).add_(mean))


def _plain_flash_attention(q, k, v, *, positions, kv_len=None,
                           sliding_window=None, scale=None,
                           logit_softcap=None, sinks=None):
    """`flash.flash_attention` through the kernels' plain versions
    (`flash_decode_ref`, `flash_prefill_ref`) on the same tensors: the
    reference side of phase 33's logits check."""
    import torch

    from ome_tpu_torch.ops import flash
    B, Sq, H, D = q.shape
    S = k.shape[1]
    scale = scale if scale is not None else D ** -0.5
    if Sq == 1:
        lo, hi = flash._decode_limits(positions, kv_len, S, sliding_window)
        return flash.flash_decode_ref(q, k, v, lo, hi, scale, logit_softcap,
                                      sinks)
    return flash.flash_prefill_ref(
        q, k, v, positions[:, 0].to(torch.int32),
        flash._kv_hi(kv_len, B, S, q.device), scale, logit_softcap,
        sliding_window, sinks)


class _AttentionCount:
    """Counts the CUDA calls of the plain attention (`xla_attention`)
    while it is entered: no CUDA tensor of any family may reach it."""

    def __init__(self):
        from ome_tpu_torch.ops import attention
        self.mod, self.orig, self.cuda_calls = attention, None, 0

    def __enter__(self):
        self.orig = self.mod.xla_attention

        def counting(q, *a, **kw):
            self.cuda_calls += int(q.is_cuda)
            return self.orig(q, *a, **kw)
        self.mod.xla_attention = counting
        return self

    def __exit__(self, *exc):
        self.mod.xla_attention = self.orig


def _family_identity(torch, label, hf, seed, n_layers, steps, prompt_lens):
    import random

    from ome_tpu_torch.engine.core import InferenceEngine
    from ome_tpu_torch.models import llama
    from ome_tpu_torch.models.config import ModelConfig
    from ome_tpu_torch.models.params import init_params
    from ome_tpu_torch.ops import flash

    dev = torch.device("cuda")
    t0 = time.monotonic()
    cfg = ModelConfig.from_hf_config(hf).replace(num_layers=n_layers,
                                                 dtype=torch.float32)
    if cfg.is_moe:
        cfg = cfg.replace(moe_impl="ragged")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    params = init_params(cfg, gen, dev)
    _seed_family_leaves(torch, params, cfg, seed)
    freqs = llama.rope_frequencies(cfg, dev)
    rng = random.Random(seed + 13)
    prompts = [[rng.randrange(3, cfg.vocab_size) for _ in range(n)]
               for n in prompt_lens]
    max_seq = max(prompt_lens) + 8 * steps

    # first-step logits: the kernels' forward against the same forward
    # through their plain versions, prefill (B2) and one decode step (B1)
    toks = torch.tensor([prompts[-1]], device=dev)
    last = torch.tensor([len(prompts[-1]) - 1], device=dev)
    logits = {}
    for side in ("kernels", "plain"):
        orig = flash.flash_attention
        if side == "plain":
            flash.flash_attention = _plain_flash_attention
        try:
            cache = llama.KVCache.create(cfg, 1, max_seq, device=dev)
            pre, cache = llama.forward(params, cfg, toks, cache=cache,
                                       rows=last, freqs=freqs)
            nxt = pre[:, -1].argmax(-1)[:, None]
            dec, _ = llama.forward(params, cfg, nxt, cache=cache,
                                   freqs=freqs)
            torch.cuda.synchronize()
        finally:
            flash.flash_attention = orig
        logits[side] = (pre, dec)
        del cache
    err = max((a - b).abs().max().item()
              for a, b in zip(logits["kernels"], logits["plain"]))
    finite = all(bool(torch.isfinite(x).all()) for x in logits["kernels"])
    del logits
    if not finite or not err <= ATOL["fp32"]:
        fail(f"family identity {label}: first-step logits of the kernels' "
             f"forward {err:.3e} from the plain versions' (tol "
             f"{ATOL['fp32']}; finite {finite})")

    flash.reset_launches()
    with _AttentionCount() as plain:
        eng = InferenceEngine(params, cfg, max_slots=len(prompts),
                              max_seq=max_seq, device="cuda", seed=seed)
        single, gaps, _ = _greedy_streams(torch, eng, prompts, steps)
        multi = _multi_streams(torch, eng, prompts, steps, k=4)
        planned, sched = _sched_streams(eng, prompts, steps,
                                        pipeline_depth=1, spec_tokens=4,
                                        steps_per_dispatch=4)
        st = dict(sched.stats)
        del eng, sched
        torch.cuda.synchronize()
    launches = dict(flash.LAUNCHES)
    for what, got in (("decode_multi K=4", multi),
                      ("scheduler spec 4 K 4", planned)):
        if got != single:
            slot = next(i for i, (a, b) in enumerate(zip(single, got))
                        if a != b)
            fail(f"family identity {label}: the {what} stream of prompt "
                 f"{slot} differs from single steps: {got[slot]} vs "
                 f"{single[slot]}")
    if plain.cuda_calls or not (launches["flash_decode"]
                                and launches["flash_prefill"]):
        fail(f"family identity {label}: launches {launches}, plain "
             f"attention on CUDA tensors {plain.cuda_calls} times")
    min_gap = min(float(g[:len(prompts)].min()) for g in gaps)
    res = {"label": label, "layers": n_layers, "logits_max_abs_err": err,
           "streams_identical": True, "steps": steps,
           "prompt_lens": list(prompt_lens), "min_top2_gap": min_gap,
           "spec_proposed": st["spec_proposed_tokens_total"],
           "spec_accepted": st["spec_accepted_tokens_total"],
           "launches": launches, "plain_cuda_calls": plain.cuda_calls,
           "secs": time.monotonic() - t0}
    log(f"[families] fp32 {label} widths, {n_layers} layers: first-step "
        f"logits (prefill of {len(prompts[-1])} tokens, then one decode "
        f"step) {err:.3e} from the plain versions' (tol {ATOL['fp32']}); "
        f"single steps = decode_multi K=4 = scheduler spec 4 / K 4 over "
        f"{steps}-token streams of prompts {list(prompt_lens)} (smallest "
        f"top-2 gap {min_gap:.3e}; spec proposed {res['spec_proposed']}, "
        f"accepted {res['spec_accepted']}); launches {launches}; plain "
        f"attention on CUDA {plain.cuda_calls} calls"
        + (" (sink attention in B1 and B2)" if cfg.attn_sinks else "")
        + f"; {res['secs']:.1f} s")
    del params
    _free_device(torch, f"the {label} identity engines")
    return res


# phases 34-37: the bf16 servers, 13 requests each (`phase_serve`):
# prompts up to 6000 tokens, past the 4096-row window where the model has
# one (gpt-oss's window is 128 rows)
FAMILY_LENGTHS_LONG = [16, 300, 1100, 2200, 3500, 4500, 5200, 6000]
FAMILY_SERVERS = (
    ("serve_gemma2_9b", {"hf": GEMMA2_9B, "label": "Gemma-2-9B",
                         "layers": CUT_LAYERS,
                         "seed_leaves": True, "max_seq": 8192,
                         "lengths": FAMILY_LENGTHS_LONG}),
    ("serve_gpt_oss_20b", {"hf": GPT_OSS_20B, "label": "gpt-oss-20b",
                           "layers": CUT_LAYERS,
                           "seed_leaves": True, "max_seq": 8192,
                           "lengths": FAMILY_LENGTHS_LONG}),
    ("serve_phi35_moe", {"hf": PHI35_MOE, "label": "Phi-3.5-MoE",
                         "layers": CUT_LAYERS,
                         "seed_leaves": True, "max_seq": 8192,
                         "lengths": FAMILY_LENGTHS_LONG}),
    ("serve_command_r7b", {"hf": COMMAND_R7B, "label": "command-r7b",
                           "layers": CUT_LAYERS,
                           "seed_leaves": True, "max_seq": 8192,
                           "lengths": FAMILY_LENGTHS_LONG}),
)


def phase_family_identity(torch, seed: int = 0, n_layers: int = 4,
                          steps: int = 24):
    """fp32, `n_layers` deep (Cohere2: one period of its pattern P 4),
    at each family's published widths (`FAMILY_MODELS`), biases, sinks
    and norm scales seeded: the first-step logits of the card's forward
    (a 2000-token prefill, then one decode step; the 4096-row windows
    are met by the servers of phases 34-37) within 2e-4 of the same
    forward through the kernels' plain versions; greedy
    streams identical across single steps, `decode_multi` K=4 and the
    spec-4 / K-4 scheduler; B1 and B2 launched (gpt-oss's sinks in
    them) and no CUDA call of the plain attention."""
    return {label: _family_identity(torch, label, hf, seed, n_layers, steps,
                                    (37, 900, 2000))
            for label, hf in FAMILY_MODELS}


# -- main -----------------------------------------------------------------------


# -- phases 38-40: the MLA family (DeepSeek-V2-Lite, DeepSeek-V3) -------------


DEEPSEEK_V2_LITE = {"_source": "deepseek-ai/DeepSeek-V2-Lite config.json",
                    "architectures": ["DeepseekV2ForCausalLM"],
                    "vocab_size": 102400, "hidden_size": 2048,
                    "intermediate_size": 10944,
                    "moe_intermediate_size": 1408,
                    "num_hidden_layers": 27, "num_attention_heads": 16,
                    "num_key_value_heads": 16, "n_shared_experts": 2,
                    "n_routed_experts": 64, "num_experts_per_tok": 6,
                    "first_k_dense_replace": 1, "moe_layer_freq": 1,
                    "q_lora_rank": None, "kv_lora_rank": 512,
                    "qk_nope_head_dim": 128, "qk_rope_head_dim": 64,
                    "v_head_dim": 128, "topk_method": "greedy",
                    "n_group": 1, "topk_group": 1, "norm_topk_prob": False,
                    "routed_scaling_factor": 1.0, "scoring_func": "softmax",
                    "rms_norm_eps": 1e-6, "rope_theta": 10000,
                    "rope_scaling": {"type": "yarn", "factor": 40,
                                     "beta_fast": 32, "beta_slow": 1,
                                     "mscale": 0.707,
                                     "mscale_all_dim": 0.707,
                                     "original_max_position_embeddings":
                                         4096},
                    "max_position_embeddings": 163840,
                    "tie_word_embeddings": False}
DEEPSEEK_V3 = {"_source": "deepseek-ai/DeepSeek-V3 config.json (its fp8 "
                          "quantization_config left out: bf16 weights)",
               "architectures": ["DeepseekV3ForCausalLM"],
               "vocab_size": 129280, "hidden_size": 7168,
               "intermediate_size": 18432, "moe_intermediate_size": 2048,
               "num_hidden_layers": 61, "num_attention_heads": 128,
               "num_key_value_heads": 128, "n_shared_experts": 1,
               "n_routed_experts": 256, "num_experts_per_tok": 8,
               "first_k_dense_replace": 3, "moe_layer_freq": 1,
               "q_lora_rank": 1536, "kv_lora_rank": 512,
               "qk_nope_head_dim": 128, "qk_rope_head_dim": 64,
               "v_head_dim": 128, "topk_method": "noaux_tc", "n_group": 8,
               "topk_group": 4, "norm_topk_prob": True,
               "routed_scaling_factor": 2.5, "scoring_func": "sigmoid",
               "rms_norm_eps": 1e-6, "rope_theta": 10000,
               "rope_scaling": {"type": "yarn", "factor": 40,
                                "beta_fast": 32, "beta_slow": 1,
                                "mscale": 1.0, "mscale_all_dim": 1.0,
                                "original_max_position_embeddings": 4096},
               "max_position_embeddings": 163840,
               "tie_word_embeddings": False}
# phase 38 cuts DeepSeek-V3's 256 routed experts to 32 in its 8 groups
# (top-4 groups, top-8 experts kept): 256 fp32 experts of 7168 x 2048 x 3
# take 45 GB per layer
V3_IDENTITY_EXPERTS = 32
# phase 40 serves DeepSeek-V3 at 4 of its 61 layers: its 3 dense layers
# and one MoE layer of 256 experts (~30 GB in bf16)
V3_SERVED_LAYERS = 4
MLA_ABSORBED_ATOL = 1e-4
# prompt lengths of the served DeepSeek models (13 requests with the
# two twins): V2-Lite to 6000 tokens at max_seq 8192, V3 to 2048 at 4096
V2_LITE_LENGTHS = [16, 100, 400, 800, 1500, 2200, 3000, 4000, 5000, 5500,
                   6000]
V3_LENGTHS = [16, 64, 100, 200, 400, 600, 800, 1000, 1500, 1800, 2048]
MLA_SERVERS = (
    ("serve_deepseek_v2_lite", {"hf": DEEPSEEK_V2_LITE,
                                "label": "DeepSeek-V2-Lite",
                                "max_seq": 8192,
                                "lengths": V2_LITE_LENGTHS}, "none"),
    ("serve_deepseek_v3", {"hf": DEEPSEEK_V3, "label": "DeepSeek-V3",
                           "layers": V3_SERVED_LAYERS, "max_seq": 4096,
                           "lengths": V3_LENGTHS}, "none"),
    # int4 dequantizes the MoE layer's 256-expert stacks every step
    # (~0.25 s): 8-token requests and no 2048-token prefill timing keep
    # the phase short
    ("serve_deepseek_v3_int4", {"hf": DEEPSEEK_V3, "label": "DeepSeek-V3",
                                "layers": V3_SERVED_LAYERS, "max_seq": 4096,
                                "lengths": V3_LENGTHS, "max_tokens": 8},
     "int4"),
)
# B4's shapes on the DeepSeek-V3 int4 server's decode steps: the shared
# experts' ws_gate / ws_up and the dense layers' w_gate / w_up
V3_INT4_SHAPES = (("ws_gate", 7168, 2048), ("w_gate", 7168, 18432))
ATTENTION_KERNELS = ("flash_decode", "flash_prefill", "flash_paged_decode",
                     "flash_decode_quantized")


def _mla_cfg(torch, hf, n_layers=None, **over):
    """(config.json dict, ModelConfig) of a published DeepSeek config,
    `n_layers` deep where given, with `over` replacing its keys."""
    from ome_tpu_torch.models.config import ModelConfig
    hf = dict(hf, **over)
    if n_layers:
        hf["num_hidden_layers"] = n_layers
    return hf, ModelConfig.from_hf_config(hf)


def _seed_router_bias(torch, params, seed: int) -> None:
    """DeepSeek-V3's selection bias drawn N(0, 0.05) instead of the
    init's zeros, so that choosing by it differs from choosing by the
    scores."""
    lay = params["layers"]
    if "router_bias" not in lay:
        return
    t = lay["router_bias"]
    gen = torch.Generator(device=t.device)
    gen.manual_seed(seed + 31)
    t.copy_(torch.randn(t.shape, generator=gen, device=t.device).mul_(0.05))


def _no_attention_kernels(what, launches) -> None:
    hit = {k: launches[k] for k in ATTENTION_KERNELS if launches.get(k)}
    if hit:
        fail(f"{what}: MLA attention launched the attention kernels {hit}")


def phase_mla_identity(torch, seed: int = 0, n_layers: int = 4,
                       steps: int = 24):
    """fp32, `n_layers` deep, at DeepSeek-V2-Lite's widths (1 dense, 3
    MoE layers) and DeepSeek-V3's (3 dense, 1 MoE layer; its 256 routed
    experts cut to `V3_IDENTITY_EXPERTS` in its 8 groups, top-4 groups
    and top-8 experts kept; the selection bias seeded), through the
    engine API: the absorbed decode's first-step logits (one row over the
    latent cache) within `MLA_ABSORBED_ATOL` of the materialized
    forward's over the whole sequence; single decode steps, `decode_multi`
    K=4 and the Scheduler at spec_tokens 4 / steps_per_dispatch 4 (its
    verify runs the materialized path over the cache) give identical
    greedy streams, with drafts proposed; no attention kernel launched.
    As in phase 12, the embeddings are tied and scaled by `EMBED_SCALE`
    for the streams, so that the random model's streams repeat n-grams
    for the drafter; the logits are compared at the init's scale."""
    import random

    from ome_tpu_torch.engine.core import InferenceEngine
    from ome_tpu_torch.models import llama
    from ome_tpu_torch.models.params import init_params
    from ome_tpu_torch.ops import flash

    out = {}
    for label, hf, over in (
            ("DeepSeek-V2-Lite", DEEPSEEK_V2_LITE, {}),
            ("DeepSeek-V3", DEEPSEEK_V3,
             {"n_routed_experts": V3_IDENTITY_EXPERTS})):
        t0 = time.monotonic()
        _, cfg = _mla_cfg(torch, hf, n_layers, **over)
        cfg = cfg.replace(dtype=torch.float32, moe_impl="ragged",
                          tie_word_embeddings=True)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        params = init_params(cfg, gen, torch.device("cuda"))
        params["embed"].mul_(EMBED_SCALE)
        _seed_router_bias(torch, params, seed)
        rng = random.Random(seed + 5)
        prompts = [[rng.randrange(3, cfg.vocab_size) for _ in range(n)]
                   for n in (20, 75, 150, 300)]
        multi_rows = []
        attn = llama.mla_attention

        def recording_attention(h, lp, c, positions, kv_len, cache_kv, idx,
                                freqs=None):
            if cache_kv is not None and h.shape[1] > 1:
                multi_rows.append(int(h.shape[1]))
            return attn(h, lp, c, positions, kv_len, cache_kv, idx, freqs)
        llama.mla_attention = recording_attention
        flash.reset_launches()
        try:
            eng = InferenceEngine(params, cfg, max_slots=4, max_seq=1024,
                                  device="cuda", seed=seed)
            single, gaps, first = _greedy_streams(torch, eng, prompts, steps)
            multi = _multi_streams(torch, eng, prompts, steps, k=4)
            verify_before = len(multi_rows)
            planned, sched = _sched_streams(eng, prompts, steps,
                                            pipeline_depth=1, spec_tokens=4,
                                            steps_per_dispatch=4)
            st = dict(sched.stats)
            del sched, eng
            # the logits at the init's own embedding scale (fp32 rounding
            # grows with the logits): the absorbed step's first decode
            # logits against the materialized forward over prompt + first
            # token (no cache), at that position
            params["embed"].div_(EMBED_SCALE)
            eng = InferenceEngine(params, cfg, max_slots=4, max_seq=1024,
                                  device="cuda", seed=seed)
            firsts, _, first = _greedy_streams(torch, eng, prompts, 2)
            del eng
            errs, scale = [], 0.0
            for i, ids in enumerate(prompts):
                toks = torch.tensor([ids + [firsts[i][0]]], device="cuda")
                ref, _ = llama.forward(params, cfg, toks)
                ref = ref[0, -1]
                errs.append((first[i] - ref).abs().max().item())
                scale = max(scale, ref.abs().max().item())
            torch.cuda.synchronize()
        finally:
            llama.mla_attention = attn
        launches = dict(flash.LAUNCHES)
        _no_attention_kernels(f"mla identity {label}", launches)
        for what, got in (("decode_multi K=4", multi),
                          ("scheduler spec 4 K 4", planned)):
            if got != single:
                slot = next(i for i, (a, b) in enumerate(zip(single, got))
                            if a != b)
                fail(f"mla identity {label}: the {what} stream of prompt "
                     f"{slot} differs from the single steps: {got[slot]} "
                     f"vs {single[slot]}")
        verify_rows = multi_rows[verify_before:]
        if st["spec_proposed_tokens_total"] <= 0 or 5 not in verify_rows:
            fail(f"mla identity {label}: the verify forward did not run "
                 f"(proposed {st['spec_proposed_tokens_total']}, cached "
                 f"multi-row MLA calls {sorted(set(verify_rows))})")
        if not max(errs) <= MLA_ABSORBED_ATOL:
            fail(f"mla identity {label}: absorbed decode logits differ from "
                 f"the materialized forward's by {max(errs):.3e} (tol "
                 f"{MLA_ABSORBED_ATOL})")
        min_gap = min(float(g[:len(prompts)].min()) for g in gaps)
        res = {"streams_identical": True, "steps": steps,
               "prompts": len(prompts), "cut": over,
               "absorbed_vs_materialized_max_abs": max(errs),
               "max_abs_logit": scale, "atol": MLA_ABSORBED_ATOL,
               "min_top2_gap": min_gap,
               "spec_steps": st["spec_steps_total"],
               "spec_proposed": st["spec_proposed_tokens_total"],
               "spec_accepted": st["spec_accepted_tokens_total"],
               "launches": launches, "secs": time.monotonic() - t0}
        out[label] = res
        cut = (f"; routed experts cut {hf['n_routed_experts']} -> "
               f"{over['n_routed_experts']} in {cfg.n_group} groups "
               f"(top-{cfg.topk_group} groups, top-{cfg.experts_per_token} "
               f"experts)" if over else "")
        log(f"[mla] fp32, {label} widths, {n_layers} layers "
            f"({cfg.first_k_dense} dense){cut}: absorbed decode logits vs "
            f"the materialized forward max abs {max(errs):.3e} (tol "
            f"{MLA_ABSORBED_ATOL}, max |logit| {scale:.3g}); single steps, "
            f"decode_multi K=4 and the scheduler (spec 4, K 4) give "
            f"identical {steps}-token streams for {len(prompts)} prompts "
            f"(smallest top-2 gap {min_gap:.3e}); spec steps "
            f"{res['spec_steps']}, proposed {res['spec_proposed']}, "
            f"accepted {res['spec_accepted']}; attention kernels launched "
            f"none; {res['secs']:.1f} s")
        del params
        _free_device(torch, f"the {label} identity engines")
    return out


def phase_mla_checkpoint(torch, seed: int = 0, n_layers: int = 4):
    """A DeepSeek checkpoint at DeepSeek-V2-Lite's widths under V3's
    architecture (so that it carries `e_score_correction_bias`, seeded),
    `n_layers` deep, bf16, HF names (`kv_a_proj_with_mqa`, the fused
    `kv_b_proj`, `mlp.gate` and `mlp.experts.*`, the shared experts, the
    leading dense layer), two shards + index, written from the port's
    seeded init under chiprun_out/ and removed after: loaded back onto
    the card bit-equal leaf for leaf, then served with `--model-dir` and
    no `--random-weights`: its first greedy tokens equal an engine's over
    the in-memory params."""
    import random
    import shutil

    from ome_tpu_torch.engine import serve
    from ome_tpu_torch.engine.core import InferenceEngine
    from ome_tpu_torch.engine.scheduler import Request
    from ome_tpu_torch.models import checkpoint
    from ome_tpu_torch.models.params import init_params

    hf, cfg = _mla_cfg(torch, DEEPSEEK_V2_LITE, n_layers,
                       architectures=["DeepseekV3ForCausalLM"])
    cfg = cfg.replace(dtype=torch.bfloat16, moe_impl="ragged")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    params = init_params(cfg, gen, torch.device("cuda"))
    _seed_router_bias(torch, params, seed)
    d = os.path.join(OUT_DIR, f"ckpt_deepseek_{n_layers}l")
    out = {}
    try:
        shutil.rmtree(d, ignore_errors=True)
        t0 = time.monotonic()
        tensors = checkpoint.hf_tensors(params, cfg)
        for name in ("model.layers.0.self_attn.kv_b_proj.weight",
                     "model.layers.1.mlp.gate.e_score_correction_bias",
                     "model.layers.1.mlp.shared_experts.gate_proj.weight",
                     "model.layers.1.mlp.experts.63.down_proj.weight",
                     "model.layers.0.mlp.gate_proj.weight"):
            if name not in tensors:
                fail(f"mla checkpoint: hf_tensors wrote no {name}")
        files = checkpoint.save_checkpoint(d, tensors, shards=2)
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(hf, f)
        nbytes = sum(t.numel() * t.element_size() for t in tensors.values())
        n_tensors = len(tensors)
        del tensors
        out.update(write_s=time.monotonic() - t0, bytes=nbytes,
                   tensors=n_tensors)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        loaded, _ = checkpoint.load_params(d, dtype=torch.bfloat16,
                                           device="cuda")
        torch.cuda.synchronize()
        out["load_s"] = time.monotonic() - t0
        out["load_gbps"] = nbytes / out["load_s"] / 1e9

        def leaves(tree, prefix=""):
            for k, v in tree.items():
                if isinstance(v, dict):
                    yield from leaves(v, prefix + k + ".")
                else:
                    yield prefix + k, v
        want, got = dict(leaves(params)), dict(leaves(loaded))
        if got.keys() != want.keys():
            fail(f"mla checkpoint: loaded leaves {sorted(got)} != written "
                 f"{sorted(want)}")
        for name, t in want.items():
            if got[name].dtype != t.dtype or not _bits_equal(
                    torch, got[name], t):
                fail(f"mla checkpoint: leaf {name} is not bit-equal to what "
                     f"was written")
        del loaded
        log(f"[mla checkpoint] DeepSeek-V2-Lite widths under "
            f"DeepseekV3ForCausalLM, {n_layers} layers, bf16: {n_tensors} "
            f"HF tensors, {nbytes / 1e9:.3f} GB in {files} + index, written "
            f"in {out['write_s']:.1f} s; load_params to the card "
            f"{out['load_s']:.2f} s ({out['load_gbps']:.2f} GB/s); all "
            f"{len(want)} leaves bit-equal (router_bias fp32 included)")
        rng = random.Random(seed + 5)
        prompts = [[rng.randrange(3, cfg.vocab_size) for _ in range(n)]
                   for n in (20, 300)]
        steps = 8
        server, sched, engine = serve.build_server(
            ["--model-dir", d, "--max-slots", "2", "--max-seq", "1024",
             "--port", "0", "--host", "127.0.0.1", "--seed", str(seed)])
        try:
            _completion(*_post(f"http://127.0.0.1:{server.port}",
                               {"prompt": prompts[0], "max_tokens": 4,
                                "temperature": 0.0}), 4,
                        "mla checkpoint completion")
            served = [list(sched.submit(Request(
                prompt_ids=ids, max_new_tokens=steps)).wait_output(300))
                for ids in prompts]
        finally:
            server.stop()
        del server, sched, engine
        twin = InferenceEngine(params, cfg, max_slots=2, max_seq=1024,
                               device="cuda", seed=seed)
        ref, _, _ = _greedy_streams(torch, twin, prompts, steps)
        del twin
        out["first_tokens"] = served
        if served != ref:
            fail(f"mla checkpoint: the served checkpoint's greedy tokens "
                 f"{served} differ from the in-memory engine's {ref}")
        log(f"[mla checkpoint] served with --model-dir (no "
            f"--random-weights): first {steps} greedy tokens of "
            f"{len(prompts)} prompts equal the engine's over the in-memory "
            f"params")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    del params
    return out


def phase_mla_pd(torch, seed: int = 0, n_layers: int = 4):
    """PD at DeepSeek-V2-Lite's widths, `n_layers` deep, bf16: a
    monolithic server, then a prefill node and a decode node, answer the
    same prompts (64-2000 tokens), one at a time, with identical greedy
    streams; the blobs carry the latent planes (576 values per token and
    layer) and a zero-width v plane; no attention kernel launched."""
    import random
    import tempfile

    from ome_tpu_torch.ops import flash

    hf, cfg = _mla_cfg(torch, DEEPSEEK_V2_LITE, n_layers)
    rng = random.Random(seed + 21)
    prompts = [[rng.randrange(3, cfg.vocab_size) for _ in range(n)]
               for n in (64, 300, 1000, 2000)]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "config.json"), "w") as f:
            json.dump(hf, f)
        flash.reset_launches()
        mono = _Node(tmp, "mla_mono", seed)
        try:
            mono_streams = [_send_all(mono, [p], what="mla monolithic")[0]
                            for p in prompts]
        finally:
            mono.stop()
        del mono
        pre = _Node(tmp, "mla_prefill", seed, "--disaggregation-mode",
                    "prefill")
        dec = _Node(tmp, "mla_decode", seed, "--disaggregation-mode",
                    "decode", "--prefill-url", pre.url)
        try:
            streams = [_send_all(dec, [p], what="mla PD")[0]
                       for p in prompts]
            rows = _pd_breakdown(pre.server.pd_prefill, dec.engine,
                                 len(prompts))
            failovers = (dec.engine.failovers, dec.engine.local_fallbacks)
        finally:
            dec.stop()
            pre.stop()
        del pre, dec
    torch.cuda.synchronize()
    launches = dict(flash.LAUNCHES)
    _no_attention_kernels("mla PD", launches)
    drift = [_first_diff(a, b) for a, b in zip(mono_streams, streams)]
    if any(d is not None for d in drift) or any(failovers):
        fail(f"mla PD: streams differ from the monolithic server's at "
             f"{drift} (failovers, local fallbacks {failovers})")
    per_row = 2 * n_layers * cfg.kv_cache_k_dim
    out.update(fetches=rows, streams_identical=True,
               blob_bytes_per_row=per_row)
    log(f"[mla pd] DeepSeek-V2-Lite widths, {n_layers} layers, bf16: PD "
        f"streams of {len(prompts)} prompts identical to the monolithic "
        f"server's; blob bytes {[r['bytes'] for r in rows]} ({per_row} B "
        f"per bucket row: {n_layers} layers x {cfg.kv_cache_k_dim} latent "
        f"values, the v plane empty); attention kernels launched none")
    return out


def phase_serve_mla(torch, model, quantization: str = "none",
                    seed: int = 0):
    """An MLA server through `serve.build_server` (`--random-weights`
    for the published config.json in `model`, cut to its "layers" where
    given; V3's selection bias seeded), bf16 or `--quantization int4`:
    13 concurrent requests of 32 tokens (8 where `model` says so; the
    prompt lengths of `model` and two twins that must agree), then
    8-token requests: two with a
    shared 1024-token prefix, the second of which must hit the prefix
    cache, and an SSE stream; TTFT / TPOT medians; the 8-slot decode
    step's device and wall ms, idle share and top kernels, and (bf16) a
    cold 2048-token prefill's; peak device memory; KV bytes per token against
    an MHA cache of the same heads. No attention kernel may launch;
    under int4 B4 must, at each of `V3_INT4_SHAPES` (its launches while
    serving read from the wrapper's count by shape, which must sum to its
    launch count, and those of one decode step)."""
    import concurrent.futures
    import random
    import tempfile

    from ome_tpu_torch.engine import serve
    from ome_tpu_torch.models.quant import quantized_bytes
    from ome_tpu_torch.ops import flash

    hf, cfg = _mla_cfg(torch, model["hf"], model.get("layers"))
    name = model["label"]
    tag = f"[serve {name}" + ("]" if quantization == "none"
                              else f" {quantization}]")
    rng = random.Random(seed)

    def prompt(n):
        return [rng.randrange(3, cfg.vocab_size) for _ in range(n)]
    out = {"quantization": quantization, "model": name,
           "layers": cfg.num_layers}
    max_seq = model["max_seq"]
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "config.json"), "w") as f:
            json.dump(hf, f)
        reqlog = os.path.join(tmp, "requests.jsonl")
        t0 = time.monotonic()
        server, sched, engine = serve.build_server(
            ["--model-dir", tmp, "--random-weights", "--seed",
             str(seed), "--max-slots", "8", "--max-seq", str(max_seq),
             "--port", "0", "--host", "127.0.0.1", "--request-log",
             reqlog, "--quantization", quantization])
        _seed_router_bias(torch, engine.model.params, seed)
        if engine.cfg.moe_impl != "ragged":
            fail(f"{tag}: the MoE server runs moe_impl "
                 f"{engine.cfg.moe_impl!r}, not the ragged dispatch")
        torch.cuda.synchronize()
        out["startup_s"] = time.monotonic() - t0
        out["device_gib_after_startup"] = \
            torch.cuda.memory_allocated() / 2**30
        out["weight_bytes"] = quantized_bytes(engine.model.params)
        out["kv_bytes_per_token"] = engine.kv_row_bytes()
        # an MHA cache of the same heads: K and V rows of 128 values
        # per head, and with K's rope dims (192 + 128)
        H, L = cfg.num_heads, cfg.num_layers
        out["mha_kv_bytes_per_token"] = L * H * 2 * 128 * 2
        out["mha_kv_bytes_per_token_with_rope"] = L * H * (
            cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
            + cfg.v_head_dim) * 2
        log(f"{tag} {hf['_source']}, random "
            f"{weight_label(engine.model.params)} weights (seed "
            f"{seed}), {L} layers ({cfg.first_k_dense} dense), slots 8, "
            f"max_seq {max_seq}: server up in {out['startup_s']:.1f} s; "
            f"weights {out['weight_bytes'] / 1e9:.3f} GB; device memory "
            f"{out['device_gib_after_startup']:.2f} GiB; KV bytes per "
            f"token {out['kv_bytes_per_token']} (MHA cache of the same "
            f"heads: {out['mha_kv_bytes_per_token']}, with the rope "
            f"dims {out['mha_kv_bytes_per_token_with_rope']})")
        url = f"http://127.0.0.1:{server.port}"
        seen = []
        submit = sched.submit

        def recording_submit(req):
            seen.append(req)
            return submit(req)
        sched.submit = recording_submit
        try:
            flash.reset_launches()
            t_batch = time.monotonic()
            twin = prompt(24)
            n_out = model.get("max_tokens", 32)
            bodies = [{"prompt": prompt(n), "max_tokens": n_out,
                       "temperature": 0.0} for n in model["lengths"]]
            bodies += [{"prompt": list(twin), "max_tokens": n_out,
                        "temperature": 0.0} for _ in range(2)]
            with concurrent.futures.ThreadPoolExecutor(
                    len(bodies)) as ex:
                futs = [ex.submit(_post, url, b) for b in bodies]
                docs = [_completion(*f.result(), n_out, f"request {i}")
                        for i, f in enumerate(futs)]
            out["batch_s"] = time.monotonic() - t_batch
            out["batch_completion_tokens"] = sum(
                d["usage"]["completion_tokens"] for d in docs)
            twins = [r for r in seen if r.prompt_ids == twin]
            if len(twins) != 2 or \
                    twins[0].output_ids != twins[1].output_ids:
                fail(f"{tag}: the twin prompts gave different outputs")
            log(f"{tag} {len(bodies)} concurrent completions (prompt "
                f"lengths {model['lengths']} + 2 x 24-token twins): all "
                f"200, {out['batch_completion_tokens']} tokens in "
                f"{out['batch_s']:.2f} s; twins identical")
            shared = prompt(1024)
            hits0 = engine.prefix_cache.hits
            for tail in (200, 150):
                _completion(*_post(url, {"prompt": shared + prompt(tail),
                                         "max_tokens": 8}), 8,
                            f"prefix {tail}")
            out["prefix_hits"] = engine.prefix_cache.hits - hits0
            if out["prefix_hits"] < 1:
                fail(f"{tag}: the shared-prefix request missed the "
                     f"prefix cache")
            status, raw = _post(url, {"prompt": prompt(64),
                                      "max_tokens": 8, "stream": True})
            events = [ln[6:] for ln in raw.decode().splitlines()
                      if ln.startswith("data: ")]
            if status != 200 or events[-1] != "[DONE]":
                fail(f"{tag}: the SSE stream did not end with [DONE]")
            torch.cuda.synchronize()
            launches = dict(flash.LAUNCHES)
            serve_shapes = dict(flash.INT4_LAUNCHES_BY_SHAPE)
        finally:
            server.stop()
        out["step"] = _step_times(torch, engine, prompt,
                                  with_prefill=quantization == "none")
        out["int4_per_decode_step"] = \
            out["step"]["decode"]["launches"]["int4_matmul"]
        with open(reqlog) as f:
            recs = [json.loads(line) for line in f]
        del engine, server, sched
    out["launches"] = launches
    out["int4_shapes_serving"] = {f"K={k} N={n}": c
                                  for (k, n), c in serve_shapes.items()}
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    _no_attention_kernels(tag, launches)
    if quantization == "int4":
        for _, K, N in V3_INT4_SHAPES:
            if serve_shapes.get((K, N), 0) <= 0:
                fail(f"{tag}: B4 never launched at K {K}, N {N} while "
                     f"serving ({out['int4_shapes_serving']})")
        if launches["int4_matmul"] <= 0:
            fail(f"{tag}: int4_matmul was never launched while serving")
    if sum(serve_shapes.values()) != launches["int4_matmul"]:
        fail(f"{tag}: B4's launches by shape {out['int4_shapes_serving']} "
             f"do not sum to its {launches['int4_matmul']} launches")
    ttft = sorted(r["ttft_s"] for r in recs if r.get("ttft_s") is not None)
    tpot = sorted(r["tpot_s"] for r in recs if r.get("tpot_s"))
    out["requests"] = len(recs)
    out["ttft_median_s"] = statistics.median(ttft)
    out["tpot_median_s"] = statistics.median(tpot)
    log(f"{tag} {len(recs)} requests: TTFT median "
        f"{out['ttft_median_s'] * 1e3:.1f} ms (max {ttft[-1] * 1e3:.1f}); "
        f"TPOT median {out['tpot_median_s'] * 1e3:.2f} ms; "
        f"{out['prefix_hits']} prefix-cache hit(s); launches while "
        f"serving {launches}; B4 launches by shape while serving "
        f"{out['int4_shapes_serving']}, in one 8-slot decode step "
        f"{out['int4_per_decode_step']}; peak device memory "
        f"{out['peak_gib']:.2f} GiB")
    return out


def phase_mla_int4_kernel(torch):
    """B4 against its plain version at m = 8 (a decode step of 8 slots)
    at DeepSeek-V3's int4 shapes (`V3_INT4_SHAPES`: the shared experts'
    K 7168, N 2048 and the dense layers' K 7168, N 18432), L2 flushed,
    with the byte bound and `_weight_int4pack_mm`'s time; the first must
    repeat its bits."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(14)
    timer = Timer(torch, torch.device("cuda"))
    weights = {}
    cases = [int4_case(torch, timer, gen, weights, name, 8, K, N,
                       repeat_bits=i == 0)
             for i, (name, K, N) in enumerate(V3_INT4_SHAPES)]
    for c in cases:
        log(f"[kernels] int4_matmul DeepSeek-V3 {c['case']}: share of bound "
            f"{c['share_of_bound']:.3f}; bf16 torch.mm over the dequantized "
            f"weight {c['bf16_mm_ms']:.4f} ms; _weight_int4pack_mm err "
            f"{c['library_err']}")
    del weights
    return check_cases({"int4_matmul": cases})


# -- phases 41-44: tensor-parallel serving, two ranks sharing one card ----------

TP = 2
# the per-rank attention of Llama-3-8B and Mixtral-8x7B at tp 2 (32 query
# heads over 8 KV heads, halved): the group size G stays 4
TP_SHAPES = ((16, 4, 128),)
TP_LOGITS_ATOL = 2e-4


def tp_logits_atol(quantization: str, n_layers: int, max_abs: float
                   ) -> float:
    """The first-step logits' tolerance of tp=2 against tp=1: fp32
    products differ only in the order of two partial sums
    (TP_LOGITS_ATOL); B4 rounds its input rows to bf16, so where tp's
    reordered sums land an fp32 activation on the other side of a bf16
    rounding, that element moves one bf16 ulp (2^-7 of its value). As
    in phase 9's B4 check, those steps add up as a random walk over the
    P = 7 x n_layers + 1 projections: 2^-7 x sqrt(P) of max |logits|."""
    if quantization == "none":
        return TP_LOGITS_ATOL
    return 2 ** -7 * math.sqrt(7 * n_layers + 1) * max_abs
TP_SAMPLING = (0.8, 40, 0.9)  # temperature, top_k, top_p
# (label, HF config or None for the 8B, weights): fp32 at the three
# widths, then the 8B widths with int4 leaves (B4 on each rank's column
# slices; wo and w_down stay int8, as quantize_params keeps them)
TP_MODELS = (("Llama-3-8B", None, "none"),
             ("Mixtral-8x7B", MIXTRAL_8X7B, "none"),
             ("DeepSeek-V2-Lite", DEEPSEEK_V2_LITE, "none"),
             ("Llama-3-8B int4", None, "int4"))
# B4 at the per-rank shapes of the 8B's int4 leaves at tp 2 (K 4096
# whole; N halved): w_gate / w_up, wq, wk / wv
TP_INT4_SHAPES = (("w_gate", 4096, 7168), ("wq", 4096, 2048),
                  ("wk", 4096, 512))
NCCL_PROBE = r"""
import datetime, os, sys, torch, torch.distributed as dist
rank, port = int(sys.argv[1]), sys.argv[2]
try:
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank,
                            device_id=torch.device("cuda:0"),
                            timeout=datetime.timedelta(seconds=60))
    t = torch.ones(4, device="cuda:0")
    dist.all_reduce(t)
    torch.cuda.synchronize()
    print("NCCL_OK", flush=True)
except Exception as e:
    lines = [ln for ln in str(e).splitlines() if ln.strip()]
    print("NCCL_REFUSED", lines[-1] if lines else repr(e), flush=True)
os._exit(0)
"""


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_tp_kernels(torch):
    """B1 and B2 at the per-rank shapes of tp 2 (`TP_SHAPES`: Llama-3-8B
    and Mixtral-8x7B, H 16 over K 4, D 128), each against its plain
    version: B1 in bf16 and fp32 at the 8B lengths, B2 causal 2048 in
    bf16 and a suffix chunk in fp32; B4 at the 8B's per-rank int4 shapes
    (`TP_INT4_SHAPES`) at m 8 with an fp32 output, as phase 42's int4
    ranks run it."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    timer = Timer(torch, torch.device("cuda"))
    lengths = [0, 1, 17, 128, 300, 1023, 2049, 4095]
    cases = {"flash_decode": [], "flash_prefill": []}
    for H, K, D in TP_SHAPES:
        kw = {"H": H, "K": K, "D": D}
        cases["flash_decode"] += [
            decode_case(torch, timer, gen, "bf16", lengths, **kw),
            decode_case(torch, timer, gen, "fp32", lengths, **kw)]
        cases["flash_prefill"] += [
            prefill_case(torch, timer, gen, "bf16", 2048, 2048, 0, **kw),
            prefill_case(torch, timer, gen, "fp32", 512, 2048, 1024, **kw)]
    weights = {}
    cases["int4_matmul"] = [
        int4_case(torch, timer, gen, weights, name, 8, K, N, "fp32")
        for name, K, N in TP_INT4_SHAPES]
    del weights
    for name, rows in cases.items():
        for c in rows:
            log(f"[tp] {name} per rank at tp {TP}: {c['case']}: ms "
                f"{c['ms']:.4f}, bound {c['bound_ms']:.4f} ms "
                f"({c['bound_by']}), share {c['bound_ms'] / c['ms']:.3f}")
    return check_cases(cases)


def _tp_cfg(torch, hf, n_layers: int):
    """A TP_MODELS entry at `n_layers`, fp32, tied embeddings (the head
    is then the vocab-sharded embedding, transposed); the MoE models on
    the dense impl, which a tp group serves."""
    from ome_tpu_torch.models.config import ModelConfig, llama3_8b
    cfg = llama3_8b() if hf is None else ModelConfig.from_hf_config(hf)
    cfg = cfg.replace(num_layers=n_layers, dtype=torch.float32,
                      tie_word_embeddings=True)
    return cfg.replace(moe_impl="dense") if cfg.is_moe else cfg


def _tp_params(torch, cfg, seed: int, quantization: str = "none",
               group=None):
    """The seeded init: the whole tree, or with `group` its rank's
    slices; quantized as serve's load does (a rank takes the split
    contractions' scales over the group, a collective)."""
    from ome_tpu_torch.models.params import init_params
    from ome_tpu_torch.models.quant import quantize_params
    from ome_tpu_torch.parallel import comm
    from ome_tpu_torch.parallel.sharding import split_contraction
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    params = init_params(cfg, gen, torch.device("cuda"),
                         shard=None if group is None else (group.rank, TP))
    if quantization == "none":
        return params
    with comm.use(group):
        return quantize_params(
            params, mode=quantization, consume=True,
            split_contraction=split_contraction() if group else (),
            amax_all=comm.amax)


def _scale_embed(eng) -> None:
    """The engine's embeddings (its head, tied) scaled by EMBED_SCALE in
    place, after the logits check (at the init's scale, as phase 38's:
    fp32 rounding grows with the logits), so that greedy streams repeat
    tokens for the drafter; a quantized table through its scales."""
    from ome_tpu_torch.models.quant import QTensor
    e = eng.model.params["embed"]
    (e.s if isinstance(e, QTensor) else e).mul_(EMBED_SCALE)


class _TokenLog:
    """A rank's engine, recording every op's sampled tokens in op order
    (the leader and a follower must record the same)."""

    def __init__(self, engine):
        self.engine = engine
        self.log = []

    def __getattr__(self, name):
        return getattr(self.engine, name)

    def prefill(self, *a, **kw):
        out = self.engine.prefill(*a, **kw)
        self.log.append(["prefill", int(out[0])])
        return out

    def decode(self, *a, **kw):
        import numpy as np
        state, toks = self.engine.decode(*a, **kw)
        self.log.append(["decode", np.asarray(toks).tolist()])
        return state, toks

    def decode_multi(self, *a, **kw):
        import numpy as np
        state, toks, adv = self.engine.decode_multi(*a, **kw)
        self.log.append(["decode_multi", np.asarray(toks).tolist(),
                         np.asarray(adv).tolist()])
        return state, toks, adv

    def verify(self, *a, **kw):
        import numpy as np
        state, out, acc = self.engine.verify(*a, **kw)
        self.log.append(["verify", np.asarray(out).tolist(),
                         np.asarray(acc).tolist()])
        return state, out, acc


def _tp_streams(eng, prompts, steps: int, sampling=None):
    """Streams of `prompts` through prefill/insert and `steps - 1`
    decode steps (greedy unless `sampling`); the slots are freed
    after."""
    import numpy as np
    n = eng.max_slots
    t, k, p = sampling or (0.0, 0, 1.0)
    arrays = (np.full(n, t, np.float32), np.full(n, k, np.int32),
              np.full(n, p, np.float32))
    state = eng.new_state()
    out = []
    for slot, ids in enumerate(prompts):
        tok, kv, length, bucket = eng.prefill(ids, t, k, p)
        state = eng.insert(state, kv, slot, length, tok, bucket)
        out.append([int(tok)])
    for _ in range(steps - 1):
        state, toks = eng.decode(state, *arrays)
        for slot, tok in enumerate(np.asarray(toks)[:len(prompts)]):
            out[slot].append(int(tok))
    for slot in range(len(prompts)):
        eng.free_slot(slot)
    return out


def _tp_script(torch, eng, prompts, steps: int, full: bool = True):
    """The streams a tp identity run compares: single steps, (`full`)
    `decode_multi` K=4 and the scheduler at spec 4 / K 4, and sampled
    steps at `TP_SAMPLING`."""
    out = {"single": _tp_streams(eng, prompts, steps),
           "spec_proposed": None, "spec_accepted": None}
    if full:
        out["multi"] = _multi_streams(torch, eng, prompts, steps, k=4)
        out["spec"], sched = _sched_streams(
            eng, prompts, steps, pipeline_depth=1, spec_tokens=4,
            steps_per_dispatch=4)
        out["spec_proposed"] = sched.stats["spec_proposed_tokens_total"]
        out["spec_accepted"] = sched.stats["spec_accepted_tokens_total"]
    out["sampled"] = _tp_streams(eng, prompts, 8, sampling=TP_SAMPLING)
    return out


def _tp_logits(torch, model, toks, ctx):
    """A forward's fp32 logits of `toks` through `model` under `ctx`
    (a tp engine's collectives, or nothing)."""
    with ctx, torch.no_grad():
        return model(toks)[0].float()


def _int4_by_shape():
    """B4's launches since the last reset, by "K=.. N=.."."""
    from ome_tpu_torch.ops.flash import INT4_LAUNCHES_BY_SHAPE
    return {f"K={k} N={n}": c for (k, n), c in
            sorted(INT4_LAUNCHES_BY_SHAPE.items())}


def tp_follower(spec) -> int:
    """Rank 1 of `phase_tp_identity` (`python3 chip_smoke.py
    --tp-follower SPEC`): for each TP_MODELS entry, its slices on the
    leader's card, the first-step logits' collectives, then the
    leader's op stream, replayed through a `_TokenLog`; the logs and
    launch counts go to spec["out"]."""
    import torch

    from ome_tpu_torch.engine import multihost
    from ome_tpu_torch.engine.sharded import ShardedInferenceEngine
    from ome_tpu_torch.ops import flash
    from ome_tpu_torch.parallel import comm
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    group = comm.Group.init(spec["coordinator"], 1, TP, "gloo")
    results = {}
    try:
        for (label, hf, quant), port in zip(TP_MODELS, spec["ports"]):
            cfg = _tp_cfg(torch, hf, spec["layers"])
            eng = ShardedInferenceEngine(
                _tp_params(torch, cfg, spec["seed"], quant, group), cfg,
                tp=TP, group=group, max_slots=4,
                max_seq=1024, device="cuda", seed=spec["seed"])
            toks = torch.tensor([spec["logits_tokens"]], device="cuda")
            _tp_logits(torch, eng.model, toks, eng._ctx())
            _scale_embed(eng)
            flash.reset_launches()
            sub = multihost.OpSubscriber("127.0.0.1", port)
            rec = _TokenLog(eng)
            rc = multihost.follower_loop(rec, sub)
            sub.close()
            torch.cuda.synchronize()
            results[label] = {"rc": rc, "log": rec.log,
                              "launches": dict(flash.LAUNCHES),
                              "int4_by_shape": _int4_by_shape(),
                              "peak_gib": torch.cuda.max_memory_allocated()
                              / 2**30}
            del eng, rec
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
    finally:
        with open(spec["out"], "w") as f:
            json.dump(results, f)
        group.close()
    return 0


def _nccl_probe():
    """Two NCCL ranks on cuda:0 (started now, read by `_nccl_result`)."""
    port = str(_free_port())
    return [subprocess.Popen([sys.executable, "-c", NCCL_PROBE, str(r),
                              port], stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
            for r in range(TP)]


def _nccl_group_of_one(torch) -> bool:
    """The port's NCCL branch of `comm.Group` (what ranks on cards of
    their own run) built and run on this card as a group of one: a sum
    and a broadcast give their input back."""
    from ome_tpu_torch.parallel import comm
    group = comm.Group.init(f"127.0.0.1:{_free_port()}", 0, 1, "nccl",
                            device=torch.device("cuda:0"), timeout=60)
    try:
        x = torch.arange(8, dtype=torch.bfloat16, device="cuda")
        y = group.all_reduce(x.clone())
        z = group.broadcast(x.clone())
        torch.cuda.synchronize()
        ok = torch.equal(x, y) and torch.equal(x, z)
    finally:
        group.close()
    log(f"[tp] comm.Group on NCCL, a group of one on cuda:0: sum and "
        f"broadcast {'equal their input' if ok else 'WRONG'}")
    if not ok:
        fail("tp: the NCCL group of one changed its input")
    return ok


def _nccl_result(procs) -> str:
    lines = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
            out = (out or "") + "NCCL_TIMEOUT"
        got = [ln for ln in out.splitlines() if ln.startswith("NCCL_")]
        tail = [ln for ln in (err or "").splitlines() if ln.strip()][-1:]
        lines += got or [f"exit {p.returncode}: {tail}"]
    return "; ".join(lines)


def phase_tp_identity(torch, seed: int = 0, n_layers: int = 4,
                      steps: int = 24):
    """tp=2 against tp=1 on the card, fp32, `n_layers` of the Llama-3-8B,
    Mixtral-8x7B and DeepSeek-V2-Lite widths (`TP_MODELS`): rank 0 in
    this process, rank 1 a child process (`tp_follower`), both on
    cuda:0 over gloo; this process is the leader, its ops replicated to
    the follower over the control channel (`engine/multihost.py`).
    First-step logits within TP_LOGITS_ATOL of the tp=1 engine's; single
    steps, `decode_multi` K=4 and the spec-4 / K-4 scheduler streams
    equal tp=1's; at TP_SAMPLING the follower's tokens equal the
    leader's, op for op; B1 and B2 launched on both ranks (the MLA model
    launches neither). Then the 8B widths with int4 leaves (each rank
    quantizes its slices, as serve's load does): logits within
    `tp_logits_atol` and single-step streams equal to a tp=1 int4
    engine's, the follower's tokens equal the leader's, and B4 launched
    on both ranks at the per-rank shapes (`TP_INT4_SHAPES`). The logits are compared at the init's scale, the
    streams run with the embeddings scaled by EMBED_SCALE (`_scale_embed`). Also: two NCCL ranks on one card are refused
    (`NCCL_PROBE`), which is why ranks that share a card run gloo."""
    import random
    import tempfile

    from ome_tpu_torch.engine import multihost
    from ome_tpu_torch.engine.core import InferenceEngine
    from ome_tpu_torch.engine.sharded import ShardedInferenceEngine
    from ome_tpu_torch.ops import flash
    from ome_tpu_torch.parallel import comm
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    t0 = time.monotonic()
    nccl = _nccl_probe()
    coordinator = f"127.0.0.1:{_free_port()}"
    ports = [_free_port() for _ in TP_MODELS]
    rng = random.Random(seed + 41)
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        out_path = os.path.join(tmp, "follower.json")
        logits_tokens = [rng.randrange(3, 30000) for _ in range(64)]
        spec = {"coordinator": coordinator, "ports": ports, "seed": seed,
                "layers": n_layers, "out": out_path,
                "logits_tokens": logits_tokens}
        follower = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--tp-follower",
             json.dumps(spec)])
        group = comm.Group.init(coordinator, 0, TP, "gloo")
        try:
            for (label, hf, quant), port in zip(TP_MODELS, ports):
                cfg = _tp_cfg(torch, hf, n_layers)
                prompts = _echo_prompts(
                    [[rng.randrange(3, 30000) for _ in range(n)]
                     for n in (20, 75, 150, 300)],
                    [[rng.randrange(3, 30000) for _ in range(8)]
                     for _ in range(4)])
                toks = torch.tensor([logits_tokens], device="cuda")
                # tp=1: the whole tree on the card, the same seed
                full = quant == "none"
                one = InferenceEngine(_tp_params(torch, cfg, seed, quant),
                                      cfg, max_slots=4, max_seq=1024,
                                      device="cuda", seed=seed)
                ref_logits = _tp_logits(torch, one.model, toks,
                                        contextlib.nullcontext())
                _scale_embed(one)
                ref = _tp_script(torch, one, prompts, steps, full)
                del one
                _free_device(torch, f"the {label} tp=1 engine")
                eng = ShardedInferenceEngine(
                    _tp_params(torch, cfg, seed, quant, group), cfg,
                    tp=TP, group=group, max_slots=4,
                    max_seq=1024, device="cuda", seed=seed)
                got_logits = _tp_logits(torch, eng.model, toks, eng._ctx())
                _scale_embed(eng)
                err = float((got_logits - ref_logits).abs().max())
                atol = tp_logits_atol(quant, n_layers,
                                      float(ref_logits.abs().max()))
                flash.reset_launches()
                c0, n0 = group.seconds, group.calls
                pub = multihost.OpPublisher(TP - 1, port=port,
                                            host="127.0.0.1")
                rec = _TokenLog(eng)
                got = _tp_script(torch, multihost.ReplicatedEngine(rec, pub),
                                 prompts, steps, full)
                pub.close()
                torch.cuda.synchronize()
                launches = dict(flash.LAUNCHES)
                keys = [k for k in ("single", "multi", "spec") if k in got]
                res[label] = {
                    "weights": quant, "int4_by_shape_rank0": _int4_by_shape(),
                    "logits_max_abs_err": err, "logits_atol": atol,
                    "layers": n_layers,
                    "streams_identical": {k: got[k] == ref[k] for k in keys},
                    "first_diff": {
                        k: [_first_diff(a, b) for a, b in zip(got[k], ref[k])]
                        for k in keys},
                    "spec_proposed": got["spec_proposed"],
                    "spec_accepted": got["spec_accepted"],
                    "leader_log": rec.log, "launches_rank0": launches,
                    "collectives": group.calls - n0,
                    "collective_s": group.seconds - c0,
                    "local_heads": (eng.cfg.num_heads,
                                    eng.cfg.kv_cache_heads)}
                log(f"[tp] {label} fp32 activations, {n_layers} layers, tp "
                    f"{TP} on one card: logits max_abs_err {err:.3e} (tol "
                    f"{atol:.3g}); streams equal to tp=1 "
                    f"{res[label]['streams_identical']}; spec proposed "
                    f"{got['spec_proposed']}, accepted "
                    f"{got['spec_accepted']}; {res[label]['collectives']} "
                    f"collectives, {res[label]['collective_s']:.2f} s; "
                    f"rank 0 launches {launches}; heads per rank (query, "
                    f"KV) {res[label]['local_heads']}")
                del eng, rec
                _free_device(torch, f"the {label} tp=2 rank 0")
        finally:
            try:
                follower.wait(timeout=300)
            except subprocess.TimeoutExpired:
                follower.kill()
                follower.wait()
            group.close()
        if follower.returncode != 0 or not os.path.exists(out_path):
            fail(f"tp identity: the follower rank exited "
                 f"{follower.returncode}")
        with open(out_path) as f:
            rank1 = json.load(f)
    res["nccl_two_ranks_one_card"] = _nccl_result(nccl)
    log(f"[tp] NCCL, two ranks on cuda:0: {res['nccl_two_ranks_one_card']}")
    res["nccl_group_of_one"] = _nccl_group_of_one(torch)
    for label, _, quant in TP_MODELS:
        r, f1 = res[label], rank1.get(label)
        if f1 is None or f1["rc"] != 0:
            fail(f"tp identity: {label}: the follower's replay ended "
                 f"{None if f1 is None else f1['rc']}")
        r["launches_rank1"] = f1["launches"]
        r["int4_by_shape_rank1"] = f1["int4_by_shape"]
        r["rank1_peak_gib"] = f1["peak_gib"]
        r["follower_tokens_equal"] = f1["log"] == r["leader_log"]
        del r["leader_log"]
        if r["logits_max_abs_err"] > r["logits_atol"]:
            fail(f"tp identity: {label}: logits differ from tp=1 by "
                 f"{r['logits_max_abs_err']:.3e}")
        if not all(r["streams_identical"].values()):
            fail(f"tp identity: {label}: streams differ from tp=1 "
                 f"{r['first_diff']}")
        if not r["follower_tokens_equal"]:
            fail(f"tp identity: {label}: the follower's tokens differ "
                 f"from the leader's")
        mla = "DeepSeek" in label
        for rank, lc in (("rank 0", r["launches_rank0"]),
                         ("rank 1", r["launches_rank1"])):
            for name in ("flash_decode", "flash_prefill"):
                if (lc[name] > 0) == mla:
                    fail(f"tp identity: {label}: {rank} launched {name} "
                         f"{lc[name]} times")
            if (lc["int4_matmul"] > 0) != (quant == "int4"):
                fail(f"tp identity: {label}: {rank} launched int4_matmul "
                     f"{lc['int4_matmul']} times")
        if quant == "int4":
            want = {f"K={K} N={N}" for _, K, N in TP_INT4_SHAPES}
            for rank in ("rank0", "rank1"):
                if not want <= set(r[f"int4_by_shape_{rank}"]):
                    fail(f"tp identity: {label}: {rank} launched B4 at "
                         f"{r[f'int4_by_shape_{rank}']}, not at every "
                         f"per-rank shape {sorted(want)}")
            log(f"[tp] {label}: B4 launches by shape, rank 0 "
                f"{r['int4_by_shape_rank0']}, rank 1 "
                f"{r['int4_by_shape_rank1']}")
        log(f"[tp] {label}: the follower's tokens equal the leader's op "
            f"for op (greedy and at temperature {TP_SAMPLING[0]}, top_k "
            f"{TP_SAMPLING[1]}, top_p {TP_SAMPLING[2]}); rank 1 launches "
            f"{r['launches_rank1']}, rank 1 peak "
            f"{r['rank1_peak_gib']:.2f} GiB")
    res["secs"] = time.monotonic() - t0
    return res


def _tp_window(torch, engine, stats_dir, prompt, iters: int = 10):
    """Decode-step times of a serving tp group, rank 0 measured here and
    rank 1 by its `--rank-stats` window: 8 slots prefilled (lengths
    64-2164) through the leader's ReplicatedEngine, then `iters` decode
    steps while `stats_dir`/window exists, each ending in a synchronize;
    rank 0's device time from one torch.profiler session over them, its
    collectives' seconds from its group."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    n = engine.max_slots
    greedy = (np.zeros(n, np.float32), np.zeros(n, np.int32),
              np.ones(n, np.float32))
    state = engine.new_state()
    for slot in range(n):
        tok, kv, length, bucket = engine.prefill(prompt(64 + 300 * slot))
        state = engine.insert(state, kv, slot, length, tok, bucket)
    for _ in range(2):
        state, toks = engine.decode(state, *greedy)
        np.asarray(toks)
    group = engine._engine.group
    window = os.path.join(stats_dir, "window")
    open(window, "w").close()
    c0 = group.seconds
    walls = []
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                t = time.perf_counter()
                state, toks = engine.decode(state, *greedy)
                np.asarray(toks)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t)
    finally:
        os.remove(window)
    busy = 0.0
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        busy += us
    for slot in range(n):
        engine.free_slot(slot)
    return {"steps": iters, "wall_ms": statistics.median(walls) * 1e3,
            "device_ms": busy / 1e3 / iters,
            "collective_share": (group.seconds - c0) / sum(walls)}


# phase 43's cut of phase 4's concurrent batch: the prompts of these
# lengths (drawn as phase 4 draws all of them), to this many tokens
TP_BATCH_LENGTHS = (16, 800, 3000)
TP_BATCH_TOKENS = 16


def phase_serve_tp(torch, seed: int = 0, before=None):
    """`serve --tp 2 --device cuda:0` at the Llama-3-8B shape, all 32
    layers, bf16 random weights from the seed of phase 4: the leader
    (rank 0) in this process, serve's own follower rank as its child,
    both on cuda:0 over gloo. A cut of phase 4's requests: three of its
    concurrent prompts (`TP_BATCH_LENGTHS`) to `TP_BATCH_TOKENS` tokens,
    then its shared-prefix pair and SSE stream: TTFT and TPOT medians,
    each batch stream's agreement with the start of phase 4's
    (`before`), B1 and B2 launched on both ranks, then an 8-slot decode
    window (`_tp_window`): each rank's device ms per step, wall ms and
    the collectives' share; peak device memory per rank from the server
    up."""
    import concurrent.futures
    import random
    import tempfile

    from ome_tpu_torch.engine import serve
    from ome_tpu_torch.ops import flash

    hf, name, cfg = _model_hf(None)
    rng = random.Random(seed)
    tag = f"[serve tp {TP}]"

    def prompt(n):
        return [rng.randrange(3, cfg.vocab_size) for _ in range(n)]
    out = {"model": name, "layers": cfg.num_layers, "tp": TP}
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "config.json"), "w") as f:
            json.dump(hf, f)
        reqlog = os.path.join(tmp, "requests.jsonl")
        stats_dir = os.path.join(tmp, "stats")
        os.makedirs(stats_dir)
        t0 = time.monotonic()
        server, sched, engine = serve.build_server(
            ["--model-dir", tmp, "--random-weights", "--seed", str(seed),
             "--max-slots", "8", "--max-seq", "4096", "--port", "0",
             "--host", "127.0.0.1", "--request-log", reqlog,
             "--tp", str(TP), "--device", "cuda:0",
             "--rank-stats", stats_dir])
        torch.cuda.synchronize()
        out["startup_s"] = time.monotonic() - t0
        torch.cuda.reset_peak_memory_stats()
        out["rank0_gib_after_startup"] = torch.cuda.memory_allocated() / 2**30
        log(f"{tag} {name}, {cfg.num_layers} layers, bf16, two ranks on "
            f"cuda:0: server up in {out['startup_s']:.1f} s; rank 0 holds "
            f"{out['rank0_gib_after_startup']:.2f} GiB ({engine.cfg.num_heads}"
            f" of {cfg.num_heads} query heads, {engine.cfg.kv_cache_heads} "
            f"of {cfg.num_kv_heads} KV heads)")
        url = f"http://127.0.0.1:{server.port}"
        seen = []
        submit = sched.submit

        def recording_submit(req):
            seen.append(req)
            return submit(req)
        sched.submit = recording_submit
        try:
            flash.reset_launches()
            # phase 4's prompts, drawn in its order (its twin first), so
            # that the later draws are phase 4's too
            lengths = [16, 100, 400, 800, 1500, 2200, 2600, 3000]
            prompt(24)
            drawn = [prompt(n) for n in lengths]
            keep = [lengths.index(n) for n in TP_BATCH_LENGTHS]
            bodies = [{"prompt": drawn[i], "max_tokens": TP_BATCH_TOKENS,
                       "temperature": 0.0} for i in keep]
            t_batch = time.monotonic()
            with concurrent.futures.ThreadPoolExecutor(len(bodies)) as ex:
                futs = [ex.submit(_post, url, b) for b in bodies]
                docs = [_completion(*f.result(), TP_BATCH_TOKENS,
                                    f"request {i}")
                        for i, f in enumerate(futs)]
            out["batch_s"] = time.monotonic() - t_batch
            out["batch_completion_tokens"] = sum(
                d["usage"]["completion_tokens"] for d in docs)
            streams = [next(r.output_ids for r in seen
                            if r.prompt_ids == b["prompt"])
                       for b in bodies]
            # the three sequential requests take 8 tokens (time: each
            # step is a few hundred ms through gloo)
            shared = prompt(1024)
            _completion(*_post(url, {"prompt": shared + prompt(200),
                                     "max_tokens": 8}), 8, "prefix 1")
            _completion(*_post(url, {"prompt": shared + prompt(150),
                                     "max_tokens": 8}), 8, "prefix 2")
            status, raw = _post(url, {"prompt": prompt(64),
                                      "max_tokens": 8, "stream": True})
            events = [ln[6:] for ln in raw.decode().splitlines()
                      if ln.startswith("data: ")]
            if status != 200 or events[-1] != "[DONE]":
                fail(f"{tag}: the SSE stream did not end with [DONE]")
            torch.cuda.synchronize()
            out["launches"] = dict(flash.LAUNCHES)
            ref_logits = (before or {}).pop("gap_logits", None)
            if ref_logits is not None:
                out["first_step_gap"] = _logit_gap(
                    _gap_logits(url, engine, sched, seed, cfg.vocab_size,
                                tag), ref_logits, tag)
            out["window"] = {"rank0": _tp_window(torch, engine, stats_dir,
                                                 prompt)}
            out["rank0_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        finally:
            server.stop()
        with open(os.path.join(stats_dir, "rank1.json")) as f:
            rank1 = json.load(f)
        with open(reqlog) as f:
            recs = [json.loads(line) for line in f]
    w1 = rank1["window"]
    if not w1["decode_ops"] or w1["device_ms"] is None:
        fail(f"{tag}: rank 1 measured no decode window ({w1})")
    out["window"]["rank1"] = {
        "steps": w1["decode_ops"],
        "wall_ms": w1["wall_s"] / w1["decode_ops"] * 1e3,
        "device_ms": w1["device_ms"] / w1["decode_ops"],
        "collective_share": w1["comm_s"] / w1["wall_s"]}
    out["rank1_peak_gib"] = rank1["peak_bytes"] / 2**30
    out["launches_rank1"] = rank1["launches"]
    out["collectives_rank1"] = rank1["collectives"]
    for rank, lc in (("rank 0", out["launches"]),
                     ("rank 1", out["launches_rank1"])):
        for kname in ("flash_decode", "flash_prefill"):
            if lc[kname] <= 0:
                fail(f"{tag}: {rank} never launched {kname} while serving")
    ttft = sorted(r["ttft_s"] for r in recs if r.get("ttft_s") is not None)
    tpot = sorted(r["tpot_s"] for r in recs if r.get("tpot_s"))
    out["requests"] = len(recs)
    out["ttft_median_s"] = statistics.median(ttft)
    out["tpot_median_s"] = statistics.median(tpot)
    ref = (before or {}).get("streams")
    if ref:
        ref = [ref[i][:TP_BATCH_TOKENS] for i in keep]
        out["streams_equal_tp1"] = sum(a == b for a, b in zip(streams, ref))
        out["first_tokens_equal_tp1"] = sum(
            a[:1] == b[:1] for a, b in zip(streams, ref))
        out["first_diff_tp1"] = [_first_diff(a, b)
                                 for a, b in zip(streams, ref)]
        if out["first_tokens_equal_tp1"] * 2 < len(ref):
            fail(f"{tag}: only {out['first_tokens_equal_tp1']} of "
                 f"{len(ref)} first tokens equal the tp=1 server's")
        log(f"{tag} against the tp=1 server (phase 4, same weights and "
            f"prompts): {out['streams_equal_tp1']} of {len(ref)} "
            f"{TP_BATCH_TOKENS}-token streams equal, {out['first_tokens_equal_tp1']} first tokens "
            f"equal; first differing step per stream "
            f"{out['first_diff_tp1']}")
    log(f"{tag} {len(recs)} requests: TTFT median "
        f"{out['ttft_median_s'] * 1e3:.1f} ms, TPOT median "
        f"{out['tpot_median_s'] * 1e3:.2f} ms; launches rank 0 "
        f"{out['launches']}, rank 1 {out['launches_rank1']}")
    for rank in ("rank0", "rank1"):
        w = out["window"][rank]
        log(f"{tag} {rank} decode step (8 slots, {w['steps']} steps): wall "
            f"{w['wall_ms']:.2f} ms, device {w['device_ms']:.2f} ms "
            f"(torch.profiler), collectives {w['collective_share']:.2f} of "
            f"the wall time; peak {out[rank + '_peak_gib']:.2f} GiB")
    return out


def _logit_gap(got, ref, tag: str) -> dict:
    """The first-step logits of tp=2 (`got`) against tp=1's (`ref`):
    their largest difference beside one bf16 ulp of the largest logit
    (the CPU test holds the same gap against the reference's tp=2)."""
    top = float(ref.abs().max())
    out = {"max_abs_gap": float((got - ref).abs().max()),
           "max_abs_logit": top,
           "bf16_ulp": 2.0 ** (math.floor(math.log2(top)) - 7),
           "argmax_equal": int(got.argmax()) == int(ref.argmax())}
    log(f"{tag} first-step bf16 logits of the gap prompt, tp={TP} against "
        f"tp=1 (phase 4): max |gap| {out['max_abs_gap']:.6g}, one bf16 ulp "
        f"of max |logit| {out['max_abs_logit']:.6g} is "
        f"{out['bf16_ulp']:.6g}; argmax equal {out['argmax_equal']}")
    return out


def phase_tp_lws(torch, seed: int = 0, n_layers: int = 4):
    """The LWS environment contract: two `python -m
    ome_tpu_torch.engine.serve` processes, JAX_COORDINATOR_ADDRESS /
    JAX_NUM_PROCESSES=2 / JAX_PROCESS_ID 0 and 1, `--control-port`, both
    on cuda:0 (`--tp-backend gloo`: the two ranks share the card,
    which NCCL refuses), Llama-3-8B widths at `n_layers` in fp32: their
    completions equal an in-process `--tp 1` server's; then the follower
    is killed and the leader's /health turns 503 ("dead")."""
    import tempfile
    import urllib.error
    import urllib.request

    from ome_tpu_torch.engine import serve
    from ome_tpu_torch.models.config import llama3_8b
    hf = _hf_config(llama3_8b().replace(num_layers=n_layers))
    res = {"layers": n_layers}
    bodies = [{"prompt": p, "max_tokens": 16, "temperature": 0.0}
              for p in ([5, 17, 300, 4000, 12, 9], list(range(100, 400)),
                        [77] * 40)]

    def texts(url):
        return [json.loads(_post(url, b)[1])["choices"][0]["text"]
                for b in bodies]

    def health(url):
        try:
            with urllib.request.urlopen(url + "/health", timeout=10) as r:
                return r.status
        except urllib.error.HTTPError as e:
            return e.code
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "config.json"), "w") as f:
            json.dump(hf, f)
        common = ["--model-dir", tmp, "--random-weights", "--seed",
                  str(seed), "--dtype", "float32", "--max-slots", "4",
                  "--max-seq", "1024", "--host", "127.0.0.1"]
        server, _, _ = serve.build_server(common + ["--port", "0",
                                                    "--device", "cuda:0"])
        try:
            want = texts(f"http://127.0.0.1:{server.port}")
        finally:
            server.stop()
        _free_device(torch, "the tp=1 server")
        coord, ctrl, http = _free_port(), _free_port(), _free_port()
        procs = []
        t0 = time.monotonic()
        for pid in range(TP):
            env = dict(os.environ, JAX_COORDINATOR_ADDRESS=f"127.0.0.1:"
                       f"{coord}", JAX_NUM_PROCESSES=str(TP),
                       JAX_PROCESS_ID=str(pid))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "ome_tpu_torch.engine.serve",
                 *common, "--device", "cuda:0", "--port", str(http),
                 "--control-port", str(ctrl), "--tp-backend", "gloo"],
                env=env,
                cwd=os.path.dirname(os.path.abspath(__file__))))
        url = f"http://127.0.0.1:{http}"
        try:
            while True:
                try:
                    if health(url) == 200:
                        break
                except OSError:
                    pass
                if any(p.poll() is not None for p in procs):
                    fail(f"tp lws: a rank exited "
                         f"{[p.poll() for p in procs]} before serving")
                if time.monotonic() - t0 > 300:
                    fail("tp lws: the group did not serve within 300 s")
                time.sleep(0.5)
            res["startup_s"] = time.monotonic() - t0
            got = texts(url)
            res["completions_equal_tp1"] = got == want
            if got != want:
                fail(f"tp lws: the group's completions differ from tp=1: "
                     f"{got} vs {want}")
            procs[1].kill()
            procs[1].wait()
            t1 = time.monotonic()
            while health(url) != 503:
                if time.monotonic() - t1 > 60:
                    fail("tp lws: the leader stayed healthy 60 s after its "
                         "follower was killed")
                time.sleep(0.05)
            res["unhealthy_after_s"] = time.monotonic() - t1
        finally:
            for p in procs:
                if p.poll() is None:
                    p.send_signal(signal.SIGTERM)
                    try:
                        p.wait(timeout=60)
                    except subprocess.TimeoutExpired:
                        p.kill()
                        p.wait()
        res["leader_exit"] = procs[0].returncode
    log(f"[tp lws] two serve processes under JAX_COORDINATOR_ADDRESS / "
        f"JAX_NUM_PROCESSES / JAX_PROCESS_ID with --control-port, cuda:0, "
        f"8B widths {n_layers} layers fp32: up in {res['startup_s']:.1f} s, "
        f"completions equal the tp=1 server's; follower killed, leader "
        f"/health 503 after {res['unhealthy_after_s']:.2f} s; leader exit "
        f"{res['leader_exit']}")
    return res


# -- phase 45: training (B2's backward, the train step) -----------------------

# the training step at full width (Llama-3-8B's widths, `CUT_LAYERS` deep,
# bf16): a batch of TRAIN_BATCH x TRAIN_SEQ tokens in TRAIN_MICROBATCHES,
# TRAIN_STEPS steps on constant targets
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICROBATCHES, TRAIN_STEPS = 4, 2048, 2, 5

# backward cases: (label, B, H, K, D, S, softcap, window, q scale,
# dtypes, sinks); the 8B's heads at the training step's sequences per
# microbatch (TRAIN_BATCH / TRAIN_MICROBATCHES), Qwen2.5-7B's G 7,
# Phi-3-mini's D 96 at G 1, Gemma-2-9B's D 256 with its softcap and a
# window shorter than S, G 32, and gpt-oss-20b's heads with its window
# and sink logits (drawn non-zero, std 2). Gemma's q is scaled by 10 so
# that its logits (std ~10) reach the cap, where 1 - (s/c)^2 falls to
# ~0.5: at randn's std 1 the softcap is near the identity and its
# derivative near 1
BWD_CASES = (("Llama-3-8B", TRAIN_BATCH // TRAIN_MICROBATCHES, 32, 8, 128,
              TRAIN_SEQ, None, None, 1.0, ("bf16", "fp32"), False),
             ("Qwen2.5-7B G 7", 1, 28, 4, 128, 2048, None, None, 1.0,
              ("bf16",), False),
             ("Phi-3-mini D 96 G 1", 1, 32, 32, 96, 2048, None, None, 1.0,
              ("bf16",), False),
             ("Gemma-2-9B D 256 softcap 50 window 1024", 1, 16, 8, 256,
              2048, 50.0, 1024, 10.0, ("bf16",), False),
             ("G 32", 1, 32, 1, 128, 2048, None, None, 1.0, ("bf16",),
              False),
             ("gpt-oss-20b D 64 window 128 sinks", 1, 64, 8, 64, 2048,
              None, 128, 1.0, ("bf16",), True))
# tolerance of each gradient: max |kernel - plain| over its rms. The
# kernel reads bf16 inputs and keeps every sum in fp32, as the plain
# version does, so the two differ by fp32 summation order alone (bf16
# cases 1.5e-5 to 3.1e-4 of rms on an H100): 2e-3 leaves a margin over
# that and stays under what a bf16 rounding of P or dS moves (1.7e-2
# and up, `BWD_FAULTS`)
BWD_REL_TOL = {"bf16": 2e-3, "fp32": 2e-4}
# B2's lse plane (bf16 forward under grad) against the plain lse: max
# |kernel - plain|, in natural-log units (an H100 reads 1e-6 to 2.3e-5,
# the largest at Gemma's logits of ~10 std)
BWD_LSE_ATOL = 1e-4
# planted faults of a plain backward written out by hand
# (`_bwd_planted`), read against the plain version at every bf16 case
# (the softcap derivative's omission where there is a softcap): each
# must read beyond the tolerance, the sound one within it
BWD_FAULTS = ("P in bf16", "dS in bf16", "no softcap derivative")


def _bwd_planted(torch, q, k, v, dout, scale, softcap, window, fault,
                 sinks=None):
    """The causal prefill's backward at base 0 with kv_hi = S written out
    in fp32 as the kernel computes it (P, with each head's sink one more
    column of its softmax where there are `sinks`; dV = P^T dO; dP = dO
    V^T; Delta = rowsum(P dP); dS = P (dP - Delta) times the softcap's
    derivative 1 - (s/c)^2; dQ = dS K scale; dK = dS^T Q scale), with
    one planted `fault` of `BWD_FAULTS` (None: none). A kernel that made
    the fault would read what this reads against the plain version."""
    B, S, H, D = q.shape
    K = k.shape[2]
    G = H // K
    f = torch.float32
    qg = q.to(f).reshape(B, S, K, G, D)
    kf, vf = k.to(f), v.to(f)
    dg = dout.to(f).reshape(B, S, K, G, D)
    s = torch.einsum("bskgd,btkd->bkgst", qg, kf) * scale
    th = None
    if softcap:
        th = torch.tanh(s / softcap)
        s = th * softcap
    row = torch.arange(S, device=q.device)
    valid = row[None, :] <= row[:, None]
    if window:
        valid &= row[None, :] > row[:, None] - window
    s = s.masked_fill(~valid, float("-inf"))
    if sinks is None:
        p = torch.softmax(s, dim=-1)
    else:
        col = sinks.float().reshape(1, K, G, 1, 1).expand(B, K, G, S, 1)
        p = torch.softmax(torch.cat([s, col], dim=-1), dim=-1)[..., :-1]
    del s
    if fault == "P in bf16":
        p = p.bfloat16().float()
    dv = torch.einsum("bkgst,bskgd->btkd", p, dg)
    dp = torch.einsum("bskgd,btkd->bkgst", dg, vf)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    del p, dp
    if softcap and fault != "no softcap derivative":
        ds = ds * (1 - th * th)
    del th
    if fault == "dS in bf16":
        ds = ds.bfloat16().float()
    dq = torch.einsum("bkgst,btkd->bskgd", ds, kf).reshape(B, S, H, D)
    dk = torch.einsum("bkgst,bskgd->btkd", ds, qg)
    return dq * scale, dk * scale, dv


# the backward's kernels by name, in the training step's profile: the
# wgmma kernel's two launches (three with a head split)
BWD_KERNELS = r"bwd_dq|bwd_dkdv|sum_splits"


def _kernel_label(name: str) -> str:
    """A backward kernel's name in a profile without its namespace and
    arguments: bwd_dkdv<128>, sum_splits."""
    m = re.search(r"(bwd_\w+|sum_splits)(<\d+>)?", name)
    return m.group(0) if m else name[:40]


def _rel_errs(torch, got, ref):
    """max |got - ref| over ref's rms, for each of dq, dk, dv (and dsink
    where both have it)."""
    return {name: ((a.double() - r.double()).abs().max()
                   / r.double().pow(2).mean().sqrt()).item()
            for name, a, r in zip(("dq", "dk", "dv", "dsink"), got, ref)}


def _ptxas(name: str, kernel: str, D: int) -> list:
    """ptxas's report for the instances of `kernel` at head_dim D in the
    build log of kernel library `name`: [(instance, registers, spill
    stores, spill loads)]."""
    from ome_tpu_torch.ops import _build
    out, inst = [], None
    for line in _build.build_logs.get(name, "").splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            inst = m.group(1) if f"{kernel}ILi{D}E" in m.group(1) else None
            spills = (0, 0)
            continue
        if inst is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.append((f"{kernel}<{D}>", int(m.group(1)), *spills))
            inst = None
    return out


def _launch_ms(torch, timer, call, names, iters: int = 7) -> list:
    """Each launch's device ms of a backward wrapper call, by CUDA events
    that the C side records around its launches (`launch_events`):
    `call(events)` makes one call; `names` are its launches in order.
    Median of `iters` runs, each from a flushed L2 behind the Timer's
    spin kernel: [(name, ms)]."""
    times = [[] for _ in names]
    for _ in range(iters):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        for e in ev:  # created before the C side records them
            e.record()
        timer.flush_buf.zero_()
        torch.cuda._sleep(Timer.SPIN_CYCLES)
        call(ev)
        torch.cuda.synchronize()
        for i in range(len(names)):
            times[i].append(ev[i].elapsed_time(ev[i + 1]))
    return [(n, statistics.median(t)) for n, t in zip(names, times)]


def _in_fresh_thread(fn):
    """fn() run on a new thread, one that has not used the card (no
    current CUDA context until something binds one), synchronized there:
    its result, or its exception raised here."""
    import torch
    box = {}

    def run():
        try:
            box["out"] = fn()
            torch.cuda.synchronize()
        except Exception as e:  # noqa: BLE001 — raised on the caller's thread
            box["err"] = e
    t = threading.Thread(target=run)
    t.start()
    t.join()
    if "err" in box:
        raise box["err"]
    return box["out"]


def bwd_case(torch, timer, gen, label, B, H, K, D, S, softcap, window,
             q_scale, dtype_name, sinks=False):
    """B2's backward at one shape against `flash_prefill_bwd_ref` (fp32
    autograd through the plain prefill, same inputs and dO): bf16 runs
    the wgmma kernel on the lse plane of B2's forward (its output held
    against the plain output within ATOL, its lse against the plain lse
    within BWD_LSE_ATOL), fp32 the scalar kernel; dq, dk and dv (and,
    with `sinks`, dsink) each within BWD_REL_TOL of its rms, the same
    bits on a second launch; bf16 also through `FlashPrefill` under
    `torch.autograd.grad` (the training path: lse saved by the forward
    and handed to the backward, the sinks an input with a gradient),
    whose output and gradients must be the wrapper's bits cast to the
    inputs' dtypes; the planted faults of `BWD_FAULTS` read against the
    same plain version (the sound hand-written backward within the
    tolerance, each fault beyond it); median ms, each launch's device
    ms (`_launch_ms`), ptxas's registers and spills, the bound (10 D
    per (row, key) pair and head, or the bytes of q, dO, dq, k, v, dk,
    dv and, bf16, the lse plane), the plain version's ms and, as a
    yardstick, the backward of one causal
    `scaled_dot_product_attention` call (none with a softcap, a window
    or sinks: SDPA takes no logit softcap or sinks, and is_causal has no
    window)."""
    from ome_tpu_torch.ops import _build, flash
    dev = torch.device("cuda")
    bf16 = dtype_name == "bf16"
    dtype = torch.bfloat16 if bf16 else torch.float32
    q, k, v = _inputs(torch, gen, B, S, S, H, K, D, dtype, dev)
    if q_scale != 1.0:
        q = (q.float() * q_scale).to(dtype)
    dout = torch.randn(B, S, H, D, generator=gen, device=dev,
                       dtype=torch.float32).to(dtype)
    sk = torch.randn(H, generator=gen, device=dev) * 2 if sinks else None
    scale = D ** -0.5
    base = torch.zeros(B, dtype=torch.int32, device=dev)
    kv_hi = torch.full((B,), S, dtype=torch.int32, device=dev)
    out, lse, lse_err, out_err = None, None, None, None
    if bf16:
        n_fwd = flash.LAUNCHES["flash_prefill"]
        out, lse = flash.flash_prefill(q, k, v, base, kv_hi, scale, softcap,
                                       window, sk, lse=True)
        # B2's launches per call: one per chunk of MAX_GROUP heads
        n_fwd = flash.LAUNCHES["flash_prefill"] - n_fwd
        plain_out, plain_lse = flash.flash_prefill_ref(
            q, k, v, base, kv_hi, scale, softcap, window, sk, lse=True)
        lse_err = (lse - plain_lse).abs().max().item()
        out_err = (out.float() - plain_out.float()).abs().max().item()
        del plain_out, plain_lse
        if not lse_err <= BWD_LSE_ATOL:
            fail(f"flash_prefill {label}: the forward's lse is {lse_err} "
                 f"off the plain lse, beyond {BWD_LSE_ATOL}")
        if not out_err <= ATOL["bf16"]:
            fail(f"flash_prefill {label}: the forward's output under lse= "
                 f"is {out_err} off the plain output, beyond {ATOL['bf16']}")
    count = "flash_prefill_bwd" if bf16 else "flash_prefill_bwd_fp32"
    before = flash.LAUNCHES[count]

    def kernel(events=None):
        return flash.flash_prefill_bwd(q, k, v, dout, scale, softcap, window,
                                       lse=lse, sinks=sk,
                                       launch_events=events)
    got = kernel()
    again = kernel()
    torch.cuda.synchronize()
    if flash.LAUNCHES[count] != before + 2:
        fail(f"flash_prefill_bwd {label}: the wrapper did not launch")
    same = all(bool(torch.equal(a, b)) for a, b in zip(got, again))
    if not same:
        fail(f"flash_prefill_bwd {label} {dtype_name}: two launches on the "
             f"same inputs gave different bits")
    # a thread that has not used the card (autograd's backward thread can
    # be one): B2 with lse= and the backward must launch there too and
    # give the same bits
    if bf16:
        again = _in_fresh_thread(kernel)
        fresh = _in_fresh_thread(lambda: flash.flash_prefill(
            q, k, v, base, kv_hi, scale, softcap, window, sk, lse=True))
        if not all(bool(torch.equal(a, b)) for a, b in
                   zip(got + fresh, again + (out, lse))):
            fail(f"flash_prefill_bwd {label}: B2 and its backward on a "
                 f"fresh thread gave other bits than on this one")
        del fresh
    del again
    autograd_same = None
    if bf16:
        # the training path: FlashPrefill's forward saves lse (and the
        # sinks) and its backward hands them to the same kernel
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        if sk is not None:
            leaves.append(sk.detach().requires_grad_())
        n0 = dict(flash.LAUNCHES)
        o2 = flash.FlashPrefill.apply(*leaves[:3], scale, softcap, window,
                                      *leaves[3:])
        grads = torch.autograd.grad(o2, leaves, dout)
        torch.cuda.synchronize()
        autograd_same = bool(torch.equal(o2, out)) and all(
            bool(torch.equal(g, a.to(t.dtype)))
            for g, a, t in zip(grads, got, leaves))
        if flash.LAUNCHES["flash_prefill"] != n0["flash_prefill"] + n_fwd \
                or flash.LAUNCHES[count] != n0[count] + 1:
            fail(f"flash_prefill_bwd {label}: FlashPrefill under autograd "
                 f"did not launch B2 ({n_fwd} launches a call) and its "
                 f"backward once each")
        if not autograd_same:
            fail(f"flash_prefill_bwd {label}: FlashPrefill under autograd "
                 f"gave other bits than flash_prefill(lse=True) and the "
                 f"backward wrapper on the same inputs")
        del o2, grads, leaves
    tol = BWD_REL_TOL[dtype_name]
    # fp32 against the plain version in fp64: the fp32 plain version's own
    # sums are off fp64 by more than BWD_REL_TOL (its distance is kept)
    ref = flash.flash_prefill_bwd_ref(
        q, k, v, dout, scale, softcap, window,
        torch.float64 if dtype_name == "fp32" else torch.float32, sinks=sk)
    plain32 = {}
    if dtype_name == "fp32":
        plain32 = _rel_errs(torch, flash.flash_prefill_bwd_ref(
            q, k, v, dout, scale, softcap, window), ref)
    for name, a in zip(("dq", "dk", "dv", "dsink"), got):
        if not torch.isfinite(a).all():
            fail(f"flash_prefill_bwd {label} {dtype_name}: non-finite {name}")
    rel = _rel_errs(torch, got, ref)
    err = max((a.double() - r.double()).abs().max().item()
              for a, r in zip(got, ref))
    planted = {}
    if bf16:
        for fault in (None,) + BWD_FAULTS:
            if fault == "no softcap derivative" and not softcap:
                continue
            errs = _rel_errs(torch, _bwd_planted(
                torch, q, k, v, dout, scale, softcap, window, fault, sk),
                ref[:3])
            planted[fault or "none"] = errs
            worst = max(errs.values())
            if fault is None and worst > tol:
                fail(f"flash_prefill_bwd {label}: the hand-written plain "
                     f"backward is {errs} off the plain version, beyond "
                     f"{tol}")
            if fault is not None and worst <= tol:
                fail(f"flash_prefill_bwd {label}: a backward with the "
                     f"planted fault '{fault}' reads {errs}, within {tol}: "
                     f"the case cannot see it")
    del ref
    ms = timer.ms(kernel)
    if bf16:
        split = flash.bwd_tile_plan(B, S, H, K, D, window,
                                    _build.sm_count(dev)).g_split
        names = [f"bwd_dq<{D}>", f"bwd_dkdv<{D}>"] + \
            (["sum_splits"] if split > 1 else [])
    else:
        names = [f"bwd_rows<{D}>", f"bwd_dkdv<{D}>", f"bwd_dq<{D}>"]
    launches_ms = _launch_ms(torch, timer, kernel, names)
    lib_name = "flash_prefill_bwd_wgmma" if bf16 else "flash_prefill_bwd"
    regs = [r for kern in ("bwd_dq", "bwd_dkdv", "bwd_rows")
            for r in _ptxas(lib_name, kern, D)]
    plain_ms = timer.ms(lambda: flash.flash_prefill_bwd_ref(
        q, k, v, dout, scale, softcap, window, sinks=sk), iters=3, warmup=1)
    lib_ms = None
    lib_none = None
    if softcap or window or sinks:
        lib_none = ("none: SDPA takes no logit softcap" if softcap else
                    "none: SDPA takes no attention sinks" if sinks else
                    "none: SDPA's is_causal takes no window")
    else:
        F = torch.nn.functional
        qs, ks, vs = (t.detach().transpose(1, 2).requires_grad_()
                      for t in (q, k, v))
        try:
            o2 = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                                enable_gqa=True)
            g2 = dout.transpose(1, 2)
            lib_ms = timer.ms(lambda: torch.autograd.grad(
                o2, (qs, ks, vs), g2, retain_graph=True))
        except TypeError:  # torch without enable_gqa: no yardstick
            lib_none = "none: this torch's SDPA has no enable_gqa"
    pairs = int(flash._prefill_pairs(base.cpu(), kv_hi.cpu(), S, window))
    esize = q.element_size()
    # q, dO, dq; k, v, dk, dv: each read or written once, in the inputs'
    # dtype (the kernel writes fp32 gradients; the bound counts the
    # function); bf16 also reads the forward's fp32 lse plane. Neither
    # kernel reads the forward's output (Delta comes from P and dP)
    nbytes = (3 * q.numel() + 4 * k.numel()) * esize + \
        (4 * B * H * S if bf16 else 0)
    bound = _bound(nbytes, 10 * D * H * pairs, dtype_name)
    case = {"case": f"bwd {label} {dtype_name} B={B} S={S} H={H} K={K} "
                    f"D={D} window={window} softcap={softcap} "
                    f"q_scale={q_scale}" + (" sinks" if sinks else ""),
            "rel_errs": rel, "rel_tol": tol, "lse_err": lse_err,
            "forward_out_err": out_err,
            "plain_fp32_vs_fp64": plain32 or None,
            "planted_faults": planted or None,
            "max_abs_err": err, "ms": ms, "launch_ms": launches_ms,
            "ptxas": regs, "plain_ms": plain_ms,
            "library_ms": lib_ms, "library_none": lib_none,
            "bitwise_repeat": same, "autograd_bitwise": autograd_same,
            **bound}
    if max(rel.values()) > tol:
        fail(f"flash_prefill_bwd {case['case']}: errors over rms {rel} "
             f"beyond {tol}")

    def errs_text(e):
        return "/".join(f"{x:.3e}" for x in e.values())
    log(f"[train] {case['case']}: {'/'.join(rel)} err/rms {errs_text(rel)} "
        f"(tol {tol}"
        + (f"; against fp64, where the fp32 plain version is "
           f"{errs_text(plain32)}" if plain32 else "")
        + (f"; forward lse {lse_err:.3e} off the plain lse, output "
           f"{out_err:.3e} off the plain output (atol {ATOL['bf16']}); "
           f"FlashPrefill under autograd gives the same bits" if bf16
           else "")
        + f"), bits repeat; {ms:.4f} ms, bound "
        f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}), share "
        f"{bound['bound_ms'] / ms:.3f}, plain {plain_ms:.3f} ms, SDPA "
        f"backward {lib_none or f'{lib_ms:.4f} ms'}")
    log(f"[train]   launches, device ms (CUDA events): "
        + ", ".join(f"{n} {t:.4f}" for n, t in launches_ms)
        + "; ptxas registers / spill stores / loads: "
        + ", ".join(f"{n} {r} / {a} / {b}" for n, r, a, b in regs))
    if planted:
        log(f"[train]   planted faults, dq/dk/dv err/rms: "
            + "; ".join(f"{name} {errs_text(e)}"
                        for name, e in planted.items()))
    return case


def phase_train_kernels(torch):
    """B2's backward at `BWD_CASES` against its plain version."""
    timer = Timer(torch, torch.device("cuda"))
    gen = torch.Generator(device="cuda").manual_seed(45)
    cases = []
    for (label, B, H, K, D, S, softcap, window, q_scale, dtypes,
         sinks) in BWD_CASES:
        for dt in dtypes:
            cases.append(bwd_case(torch, timer, gen, label, B, H, K, D, S,
                                  softcap, window, q_scale, dt, sinks))
            _free_device(torch, f"the backward case {label} {dt}")
    return {"flash_prefill_bwd": cases}


TRAIN_TARGET = 7
# at the default lr 3e-4 AdamW's first step alone takes a constant
# target's loss from 12.57 to 4e-9 at these widths, and the next to 0.0
# in fp32 (H100, 700 W): lr 1e-5 keeps 5 steps a falling trajectory
TRAIN_LR = 1e-5
# the identity steps: 2 layers at the 8B's widths, in fp32 (the scalar
# backward) and in bf16 (the wgmma backward, the training step's), the
# loss and gradients of one step of a batch of 2 x 512 through the
# kernels and through their plain versions
TRAIN_ID_LAYERS, TRAIN_ID_SHAPE = 2, (2, 512)
# the loss: |kernels - plain| / |plain| (an H100 reads 0 in fp32, 1.7e-5
# in bf16)
TRAIN_ID_LOSS_RTOL = {"fp32": 2e-4, "bf16": 2e-4}
# each leaf's gradient (`_train_identity`'s metric): fp32, max |kernels -
# plain| over the plain gradient's rms: on an H100 the sound step reads
# 8.9e-6 to 3.6e-4 (the embedding's, whose rms the untouched rows
# dilute), the step with dk and dv swapped 1.8 to 119 on every leaf that
# attention's gradient reaches; bf16, the rms of the difference over the
# plain gradient's: the sound step 8.8e-3 to 1.5e-2, the swapped one 0.30
# to 1.70 on those leaves
TRAIN_ID_GRAD_RTOL = {"fp32": 1e-3, "bf16": 5e-2}


def _grouped_mm_backward(torch) -> str:
    """Whether `torch._grouped_mm` (the MoE experts' ragged products on
    the card) has a backward in this torch: "ok", or the error."""
    dev = torch.device("cuda")
    xs = torch.randn(256, 512, device=dev, dtype=torch.bfloat16,
                     requires_grad=True)
    w = torch.randn(8, 512, 256, device=dev, dtype=torch.bfloat16,
                    requires_grad=True)
    offs = torch.arange(32, 257, 32, device=dev, dtype=torch.int32)
    try:
        torch._grouped_mm(xs, w, offs=offs).float().sum().backward()
        torch.cuda.synchronize()
        return "ok" if xs.grad is not None and w.grad is not None \
            else "no gradient"
    except Exception as e:  # noqa: BLE001 — recorded, not a failure
        return f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"


def _train_8b(torch, batch: int):
    """TRAIN_STEPS steps of the 8B's widths at `CUT_LAYERS` layers in
    bf16 (tp = pp = dp = 1) through `make_train_step`; every loss must
    fall, B2 and its backward must launch."""
    from ome_tpu_torch.models.config import llama3_8b
    from ome_tpu_torch.models.params import param_count
    from ome_tpu_torch.ops import flash
    from ome_tpu_torch.parallel.mesh import MeshConfig
    from ome_tpu_torch.train import step as ts
    dev = torch.device("cuda")
    cfg = llama3_8b().replace(num_layers=CUT_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    step, init_state = ts.make_train_step(cfg, MeshConfig(),
                                          TRAIN_MICROBATCHES, lr=TRAIN_LR,
                                          device=dev)
    params, opt = init_state(seed=0)
    n_params = param_count(params)
    gen = torch.Generator(device=dev).manual_seed(45)
    tokens = torch.randint(0, cfg.vocab_size, (batch, TRAIN_SEQ),
                           generator=gen, device=dev)
    targets = torch.full_like(tokens, TRAIN_TARGET)
    flash.reset_launches()
    losses, walls = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, opt, loss = step(params, opt, tokens, targets)
        losses.append(float(loss))
        walls.append(time.perf_counter() - t)
    launches = dict(flash.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(x) for x in losses) or any(
            b >= a for a, b in zip(losses, losses[1:])):
        fail(f"train: the 8B-width losses did not fall every step: {losses}")
    for name in ("flash_prefill", "flash_prefill_bwd"):
        if launches[name] == 0:
            fail(f"train: {name} was not launched by the training steps")
    # B2's backward in the step: the wgmma kernel's launches (bf16)
    device_ms, top, _, bwd_rows = _device_profile(
        torch, lambda: step(params, opt, tokens, targets), 1,
        match=BWD_KERNELS)
    bwd_ms = sum(r[0] for r in bwd_rows)
    wall_ms = statistics.median(walls[1:]) * 1e3
    n_tok = batch * TRAIN_SEQ
    res = {"layers": CUT_LAYERS, "batch": batch, "seq": TRAIN_SEQ,
           "lr": TRAIN_LR,
           "microbatches": TRAIN_MICROBATCHES, "params": n_params,
           "losses": losses, "step_wall_ms": [w * 1e3 for w in walls],
           "wall_ms": wall_ms, "device_ms": device_ms,
           "backward_ms": bwd_ms, "backward_share": bwd_ms / device_ms,
           "backward_kernels": bwd_rows,
           "tokens_per_s": n_tok / wall_ms * 1e3,
           "mfu": 6 * n_params * n_tok / (wall_ms / 1e3)
           / PEAK_FLOPS["bf16"],
           "max_memory_allocated": peak, "launches": launches,
           "top_kernels": top}
    log(f"[train] Llama-3-8B widths, {CUT_LAYERS} layers, bf16, "
        f"{n_params / 1e9:.3f} B params, batch {batch} x {TRAIN_SEQ} in "
        f"{TRAIN_MICROBATCHES} microbatches, lr {TRAIN_LR}: losses "
        f"{' > '.join(f'{x:.4f}' for x in losses)}; step wall "
        f"{wall_ms:.1f} ms (median of steps 2-{TRAIN_STEPS}), device "
        f"{device_ms:.1f} ms, {res['tokens_per_s']:.0f} tokens/s, "
        f"model-FLOPs share {res['mfu']:.4f} of {PEAK_FLOPS['bf16'] / 1e12:.0f}"
        f" TFLOP/s; max_memory_allocated {peak / 2**30:.2f} GiB; B2 "
        f"forward {launches['flash_prefill']} / backward "
        f"{launches['flash_prefill_bwd']} launches; B2's backward "
        f"{bwd_ms:.2f} ms of the step's device time "
        f"({res['backward_share']:.3f}: "
        + ", ".join(f"{_kernel_label(n)} {ms:.2f} ms x{k}"
                    for ms, k, n in bwd_rows) + ")")
    for ms, n, name in top:
        log(f"[train]   device {ms:.2f} ms x{n} {name[:90]}")
    return res


def _swapped_flash_attention(torch):
    """`flash.flash_attention` under grad through B2 whose backward hands
    dk back as dv and dv as dk: a planted fault that the identity's
    gradient check must reject."""
    from ome_tpu_torch.ops import flash

    class Swapped(flash.FlashPrefill):
        @staticmethod
        def backward(ctx, dout):
            dq, dk, dv, *rest = flash.FlashPrefill.backward(ctx, dout)
            return (dq, dv, dk, *rest)

    def attend(q, k, v, *, positions, kv_len=None, sliding_window=None,
               scale=None, logit_softcap=None, sinks=None):
        flash.check_prefill_grad(q, k, v, positions, kv_len, sinks)
        return Swapped.apply(q, k, v, scale or q.shape[-1] ** -0.5,
                             logit_softcap, sliding_window, sinks)
    return attend


def _train_identity(torch, dtype_name: str):
    """The loss and gradients of one train step of TRAIN_ID_LAYERS layers
    at the 8B's widths in `dtype_name` (fp32: the scalar backward; bf16:
    the wgmma one on the forward's lse) through the kernels (B2 and its
    backward) against the same through their plain versions
    (`_plain_flash_attention`): the loss within TRAIN_ID_LOSS_RTOL, each
    leaf's gradient within TRAIN_ID_GRAD_RTOL of its rms; then through a
    B2 whose backward swaps dk and dv, which must fall outside it."""
    from ome_tpu_torch.models.config import llama3_8b
    from ome_tpu_torch.ops import flash
    from ome_tpu_torch.parallel.mesh import MeshConfig
    from ome_tpu_torch.train import step as ts
    dev = torch.device("cuda")
    cfg = llama3_8b().replace(
        num_layers=TRAIN_ID_LAYERS,
        dtype=torch.float32 if dtype_name == "fp32" else torch.bfloat16)
    count = "flash_prefill_bwd_fp32" if dtype_name == "fp32" \
        else "flash_prefill_bwd"
    loss_rtol = TRAIN_ID_LOSS_RTOL[dtype_name]
    grad_rtol = TRAIN_ID_GRAD_RTOL[dtype_name]
    gen = torch.Generator(device=dev).manual_seed(46)
    tokens = torch.randint(0, cfg.vocab_size, TRAIN_ID_SHAPE, generator=gen,
                           device=dev)
    targets = torch.randint(0, cfg.vocab_size, TRAIN_ID_SHAPE,
                            generator=gen, device=dev)
    step, init_state = ts.make_train_step(cfg, MeshConfig(), 1, device=dev)
    params, opt = init_state(seed=1)
    del opt

    def run(attend):
        flash.reset_launches()
        orig = flash.flash_attention
        if attend is not None:
            flash.flash_attention = attend
        try:
            loss, grads = step.loss_and_grads(params, tokens, targets)
        finally:
            flash.flash_attention = orig
        return (float(loss), {n: g.float() for n, g in ts._leaves(grads)},
                dict(flash.LAUNCHES))
    lk, gk, nk = run(None)
    lp, gp, np_ = run(_plain_flash_attention)

    # fp32: max |kernels - plain| over the plain gradient's rms; bf16:
    # the rms of the difference over it (bf16 rounds each element by up
    # to 2^-9 of itself, and the largest elements of the embedding's and
    # lm_head's gradients are ~10^2 of their rms, so one rounding there
    # moves the max by ~1 of the rms: on an H100 0.87 at lm_head, which
    # attention's backward does not reach)
    def rel_errs(got):
        if dtype_name == "fp32":
            return {n: ((got[n] - r).abs().max() / r.pow(2).mean().sqrt()
                        ).item() for n, r in gp.items()}
        return {n: ((got[n] - r).pow(2).mean().sqrt()
                    / r.pow(2).mean().sqrt()).item() for n, r in gp.items()}
    rel = abs(lk - lp) / abs(lp)
    grad_rel = rel_errs(gk)
    del gk
    ls, gs, ns = run(_swapped_flash_attention(torch))
    swapped_rel = rel_errs(gs)
    del gs, gp
    worst = max(grad_rel, key=grad_rel.get)
    metric = "max |err| / rms" if dtype_name == "fp32" else "rms(err) / rms"
    res = {"dtype": dtype_name, "grad_metric": metric, "loss_kernels": lk,
           "loss_plain": lp, "loss_rel": rel, "loss_rtol": loss_rtol,
           "grad_rel_errs": grad_rel, "grad_rtol": grad_rtol,
           "swapped_dk_dv_grad_rel_errs": swapped_rel,
           "launches_kernels": nk, "launches_plain": np_,
           "launches_swapped": ns}
    log(f"[train]   {dtype_name} gradients, {metric}, kernels / swapped: "
        + "; ".join(f"{n} {grad_rel[n]:.2e} / {swapped_rel[n]:.2e}"
                    for n in grad_rel))
    tag = f"train identity {dtype_name}"
    if rel > loss_rtol or grad_rel[worst] > grad_rtol:
        fail(f"{tag}: loss {lk} vs plain {lp} (rel {rel:.3e}, tol "
             f"{loss_rtol}); gradients, {metric}, {grad_rel} (tol "
             f"{grad_rtol})")
    if max(swapped_rel.values()) <= grad_rtol:
        fail(f"{tag}: a B2 backward that swaps dk and dv reads "
             f"{swapped_rel}, within {grad_rtol}: the check cannot see it")
    if nk[count] != TRAIN_ID_LAYERS or any(np_.values()) or \
            ns[count] != TRAIN_ID_LAYERS:
        fail(f"{tag}: launches {nk} through the kernels, {np_} "
             f"through the plain versions, {ns} through the swapped one")
    caught = max(swapped_rel, key=swapped_rel.get)
    log(f"[train] identity, {TRAIN_ID_LAYERS} {dtype_name} layers at the 8B "
        f"widths, batch {TRAIN_ID_SHAPE}: loss {lk:.7f} through the "
        f"kernels, {lp:.7f} through their plain versions (rel {rel:.3e}, "
        f"tol {loss_rtol}); gradients, {metric}, at most "
        f"{grad_rel[worst]:.3e} ({worst}; tol {grad_rtol}); B2 "
        f"backward ({count}) launched {nk[count]} times, the plain step "
        f"none; with dk and dv swapped in B2's backward the gradients read "
        f"up to {swapped_rel[caught]:.3e} ({caught}; loss {ls:.7f})")
    return res


def _train_resume(torch):
    """A narrow model (hidden 1024, 2 layers, bf16): 2 steps, save, one
    more step; restore into a fresh step and take it again: the two
    losses must be the same bits."""
    import shutil

    from ome_tpu_torch.models.config import llama3_8b
    from ome_tpu_torch.parallel.mesh import MeshConfig
    from ome_tpu_torch.train import checkpoint
    from ome_tpu_torch.train import step as ts
    dev = torch.device("cuda")
    cfg = llama3_8b().replace(hidden_size=1024, num_heads=8, num_kv_heads=2,
                              intermediate_size=3584, num_layers=2)
    gen = torch.Generator(device=dev).manual_seed(47)
    tokens = torch.randint(0, cfg.vocab_size, (4, 512), generator=gen,
                           device=dev)
    targets = torch.full_like(tokens, TRAIN_TARGET)
    d = os.path.join(OUT_DIR, "train_ckpt")
    shutil.rmtree(d, ignore_errors=True)
    try:
        step, init_state = ts.make_train_step(cfg, MeshConfig(), 2,
                                              device=dev)
        params, opt = init_state(seed=2)
        for _ in range(2):
            params, opt, _ = step(params, opt, tokens, targets)
        checkpoint.save_train_state(d, 2, *step.whole(params, opt))
        params, opt, loss_next = step(params, opt, tokens, targets)
        del params, opt
        step2, init2 = ts.make_train_step(cfg, MeshConfig(), 2, device=dev)
        n, wp, wo = checkpoint.restore_train_state(d, None, None)
        params, opt = init2(wp, wo)
        params, opt, loss_resumed = step2(params, opt, tokens, targets)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    same = bool(torch.equal(loss_next, loss_resumed))
    if n != 2 or not same:
        fail(f"train resume: step {n}, next loss {float(loss_next)!r} vs "
             f"resumed {float(loss_resumed)!r}")
    log(f"[train] checkpoint, hidden 1024, 2 layers, bf16: saved at step 2, "
        f"restored; the next loss {float(loss_next):.6f} equals the "
        f"uninterrupted run's bit for bit")
    return {"loss_next": float(loss_next),
            "loss_resumed": float(loss_resumed), "bitwise": same}


def phase_train(torch):
    """Phase 45: B2's backward against its plain version, the 8B-width
    training step, the kernel/plain identity steps (fp32 and bf16) and a
    resume."""
    res = phase_train_kernels(torch)
    res["grouped_mm_backward"] = _grouped_mm_backward(torch)
    log(f"[train] torch._grouped_mm backward in torch {torch.__version__}: "
        f"{res['grouped_mm_backward']}")
    _free_device(torch, "the backward cases")
    batch = TRAIN_BATCH
    try:
        res["step"] = _train_8b(torch, batch)
    except torch.cuda.OutOfMemoryError:
        _free_device(torch, "the 8B training step that ran out of memory")
        batch //= 2
        log(f"[train] out of memory at batch {TRAIN_BATCH}: batch {batch}")
        res["step"] = _train_8b(torch, batch)
    _free_device(torch, "the 8B-width training step")
    res["identity"] = _train_identity(torch, "fp32")
    _free_device(torch, "the fp32 training identity steps")
    res["identity_bf16"] = _train_identity(torch, "bf16")
    _free_device(torch, "the bf16 training identity steps")
    res["resume"] = _train_resume(torch)
    return res


# -- phase 46: the fleet under faults and load --------------------------------

FLEET_LAYERS = 4
# the paged kernel's tile; two usable 32-row blocks (block 0 is the trash
# block) for two slots: a sequence of the phase's traces (24-48 new tokens
# over prompts of 5-13) crosses into its second block mid-decode, so two
# running sequences exhaust the pool and the engine preempts and recomputes
FLEET_KV_BLOCK = 32
FLEET_KV_BLOCKS = 3
# the closed loop and the fleet: the reference harness's 640 rows (40
# blocks of 16) in 32-row blocks. The utilization gauge counts the trash
# block as occupied, so a 3-block pool reads 1/3 when idle, above the
# controller's scale-down threshold (0.3 of kv_util_high 0.9)
FLEET_LOOP_KV_BLOCKS = 20
FLEET_SEED_SCAN = 2000
GiB = 1 << 30


def _fleet_model_dir(root: str, hf: dict, layers: int) -> str:
    """A model directory holding only config.json (`--random-weights`
    draws the weights from seed 0), `layers` deep."""
    d = os.path.join(root, hf["_source"].split()[0].replace("/", "--"))
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(dict(hf, num_hidden_layers=layers), f)
    return d


def _weight_bytes(hf: dict, layers: int) -> int:
    """fp32 weight bytes of a dense Llama-family config at `layers`:
    embedding and head (untied), q/k/v/o (and Qwen2's q/k/v biases), the
    gated MLP and the norms."""
    h, v = hf["hidden_size"], hf["vocab_size"]
    H, K = hf["num_attention_heads"], hf["num_key_value_heads"]
    D = hf.get("head_dim") or h // H
    inter = hf["intermediate_size"]
    bias = (H + 2 * K) * D if "qwen2" in hf.get("model_type", "") else 0
    per_layer = (h * H * D + 2 * h * K * D + H * D * h + bias
                 + 3 * h * inter + 2 * h)
    tied = hf.get("tie_word_embeddings", False)
    return 4 * (v * h * (1 if tied else 2) + layers * per_layer + h)


def _scan_seed(chaos, topo, index, workload, spread, want):
    """The first seed whose plan (`_plan_episode` of episode `index` over
    this topology and workload) has the events `want` asks for, as the
    reference's tests chose theirs."""
    for seed in range(FLEET_SEED_SCAN):
        ep = chaos._plan_episode(seed, index, topo, len(workload), spread,
                                 workload=workload)
        if want(ep):
            return seed
    fail(f"fleet: no seed below {FLEET_SEED_SCAN} plans the episode")


def _hbm(sample: dict) -> float:
    return sample.get("ome_engine_hbm_bytes_in_use", 0.0)


def _preemptions(samples: dict) -> float:
    return sum(v for s in samples.values() for k, v in s.items()
               if k.startswith("ome_engine_class_preemptions_total"))


def _kernels_ran(programs: dict, device: str) -> dict:
    """Which attention kernels a child's program ledger shows dispatched:
    on a CUDA engine a prefill program runs B2 and a paged decode program
    B3 (the wrappers launch their kernel on a CUDA tensor or raise)."""
    out = {"flash_prefill": 0, "flash_paged_decode": 0}
    for row in programs.values():
        on_card = (row.get("device") or {}).get("platform") == "gpu"
        if on_card != (device != "cpu"):
            continue
        for key, n in (row.get("dispatches") or {}).items():
            if key.startswith("prefill"):
                out["flash_prefill"] += n or 0
            elif key.startswith("decode") and "_paged" in key:
                out["flash_paged_decode"] += n or 0
    return out


def _fleet_chaos(chaos, trace_mod, base: str, model_dir: str,
                 device: str, card: str) -> dict:
    """Two seeded chaos episodes through the port's harness: one unified
    engine behind the asyncio router (an engine_step fault and a SIGKILL
    mid-decode), and a PD pair (a pd_insert fault on the decode node, the
    prefill peer killed mid-handoff). Each runs a bursty greedy/sampled
    trace that keeps both slots busy (the kill lands on journaled work);
    every invariant of the harness must hold, and every greedy stream a
    child's journal finished must equal the oracle's by token ids."""
    tr = trace_mod.synthetic_trace(20, n=14, base_rate=5.0,
                                   burst_factor=3.0, max_tokens=(24, 48),
                                   greedy_fraction=0.7)
    for i, r in enumerate(tr):  # two tenants: every third interactive
        r.priority = "interactive" if i % 3 == 2 else "batch"
    path = os.path.join(base, "chaos-trace.jsonl")
    trace_mod.save_trace(tr, path)
    workload = chaos.requests_from_trace(pathlib.Path(path))
    spread = max(3.0, max(r.delay for r in workload))
    kv = dict(kv_block=FLEET_KV_BLOCK, kv_blocks=FLEET_KV_BLOCKS)
    unified = chaos.Topology(prefill=0, decode=0, unified=1, router=True,
                             **kv)
    pd = chaos.Topology(prefill=1, decode=1, unified=0, router=False,
                        pd_local_fallback=True, **kv)

    def kill_mid_decode(ep):
        return ("engine_step" in ep.fault_specs.get("unified0", "")
                and [(a, t) for _, a, t in ep.events]
                == [("sigkill", "unified0")]
                and ep.events[0][0] >= 1.0)

    def kill_mid_handoff(ep):
        return (ep.fault_specs.get("decode0", "").startswith("pd_insert")
                and [(a, t) for _, a, t in ep.events]
                == [("kill_prefill", "prefill0")])
    runner = chaos.ChaosRunner(unified, pathlib.Path(base) / "chaos",
                               model_dir=model_dir, device=device,
                               journal_drain_timeout=90.0)
    out = {}
    try:
        for index, (label, topo, want) in enumerate((
                ("unified", unified, kill_mid_decode),
                ("pd", pd, kill_mid_handoff))):
            seed = _scan_seed(chaos, topo, index, workload, spread, want)
            ep = chaos._plan_episode(seed, index, topo, len(workload),
                                     spread, workload=workload)
            log(f"[fleet] chaos {label}: seed {seed} episode {index}, "
                f"{len(ep.requests)} requests over {spread:.2f} s, faults "
                f"{ep.fault_specs}, events "
                f"{[(round(a, 2), b, c) for a, b, c in ep.events]}")
            t0 = time.monotonic()
            runner.run_episode(ep)
            secs = time.monotonic() - t0
            m = ep.measured
            if ep.violations:
                fail(f"fleet: chaos {label} (seed {seed}): "
                     + "; ".join(ep.violations)[:4000])
            ran = _kernels_ran(m["programs"], device)
            greedy = sum(r.temperature == 0.0 for r in ep.requests)
            tokens = {c: sum(s.get(f'ome_engine_class_tokens_total'
                                   f'{{class="{c}"}}', 0.0)
                             for s in m["metrics"].values())
                      for c in ("interactive", "batch")}
            res = {"seed": seed, "seconds": secs, "class_tokens": tokens,
                   "schedule": ep.schedule(), "ready_s": m["ready_s"],
                   "to_resume": m.get("to_resume", {}),
                   "resume_s": m.get("resume_s", {}),
                   "journal_drain_s": m["journal_drain_s"],
                   "greedy_ids": m["greedy_ids"], "greedy_requests": greedy,
                   "answered_200": sum(r.status == 200
                                       for r in ep.requests),
                   "kernels_in_children": ran,
                   "preemptions": _preemptions(m["metrics"]),
                   "hbm_bytes_in_use": {k: _hbm(s) for k, s in
                                        m["metrics"].items()},
                   "programs": m["programs"]}
            out[label] = res
            log(f"[fleet] chaos {label} ({card}): no violation in "
                f"{secs:.1f} s; greedy streams held by token ids against "
                f"the oracle {res['greedy_ids']}; journaled requests left "
                f"for the respawn {res['to_resume']}; spawn-to-/health s "
                f"per incarnation {m['ready_s']}; respawn-to-resume s "
                f"{res['resume_s']}; journal drain "
                f"{res['journal_drain_s']:.3f} s; preemptions "
                f"{res['preemptions']:.0f}; tokens by class (last "
                f"incarnations) {tokens}; kernels the children's "
                f"ledgers show dispatched {ran}; allocator bytes in use per "
                f"child incarnation (GiB) "
                f"{ {k: round(v / GiB, 3) for k, v in res['hbm_bytes_in_use'].items()} }")
            if res["greedy_ids"] <= 0:
                fail(f"fleet: chaos {label}: no greedy stream was held "
                     "against the oracle by token ids")
            if label == "unified" and not res["to_resume"].get("unified0"):
                fail("fleet: chaos unified: the SIGKILL left no journaled "
                     "request for the respawn to resume")
        out["oracle_ready_s"] = runner.oracle.ready_s if runner.oracle \
            else []
    finally:
        runner.close()
    ran = {k: sum(out[e]["kernels_in_children"][k] for e in ("unified", "pd"))
           for k in ("flash_prefill", "flash_paged_decode")}
    if min(ran.values()) <= 0:
        fail(f"fleet: the children's program ledgers show no B2 or no B3 "
             f"dispatch: {ran}")
    out["kernels_in_children"] = ran
    return out


def _fleet_closed_loop(controller, trace_mod, base: str, model_dir: str,
                       device: str, card: str) -> dict:
    """`run_closed_loop` with 1-2 replicas on the reference smoke's seeded
    bursty trace (seed 7, 16 requests, base rate 2/s, burst 8x, 24-48
    tokens; the busiest 2 s doubled): up during the burst, back to one
    after it, every request answered, no journal left live. The scale-up
    spawn holds the controller's thread for a cold start (~20 s on the
    card), so the loop settles up to 30 s after the replay for the
    scale-down to land."""
    path = os.path.join(base, "loop-trace.jsonl")
    trace_mod.save_trace(trace_mod.synthetic_trace(
        7, n=16, base_rate=2.0, burst_factor=8.0, max_tokens=(24, 48)), path)
    args = controller.build_parser().parse_args([
        "--trace", path, "--seed", "7", "--amplify", "2",
        "--min-engines", "1", "--max-engines", "2", "--interval", "0.5",
        "--slo-ttft-p99", "0.4", "--slo-queue-wait-p99", "0.2",
        "--queue-depth-high", "1.5", "--up-stable-ticks", "2",
        "--down-stable-ticks", "4", "--cooldown-ticks", "3",
        "--down-threshold", "0.3", "--model-dir", model_dir,
        "--kv-block", str(FLEET_KV_BLOCK), "--kv-blocks",
        str(FLEET_LOOP_KV_BLOCKS), "--device", device,
        "--settle-seconds", "30",
        "--base-dir", os.path.join(base, "loop")])
    t0 = time.monotonic()
    rep = controller.run_closed_loop(args)
    secs = time.monotonic() - t0
    moves = [d for d in rep["decisions"] if d["target"] != d["size"]]
    t_start = rep["decisions"][0]["at"] if rep["decisions"] else 0.0
    sizes = [(0.0, 1)] + [(round(d["at"] - t_start, 2), d["target"])
                          for d in moves]
    ups = [s for s in rep["spawns"] if "decision_to_registered_s" in s]
    out = {"seconds": secs, "replicas_over_time": sizes,
           "scale_up_s": [s["decision_to_registered_s"] for s in ups],
           "requests": rep["requests"], "errors": rep["errors"],
           "journal_leftover": rep["journal_leftover"],
           "drains": rep["drains"], "engine_seconds": rep["engine_seconds"],
           **{k: rep[k] for k in (
               "ttft_p50_s", "ttft_p99_s", "tpot_p50_s", "tpot_p99_s",
               "e2e_p50_s", "e2e_p99_s", "engine_requests",
               "engine_ttft_p50_s", "engine_ttft_p99_s",
               "engine_tpot_p50_s", "engine_tpot_p99_s")}}
    log(f"[fleet] closed loop ({card}): {rep['requests']} requests, "
        f"{rep['errors']} errors, in {secs:.1f} s; replicas over time "
        f"(s from the first tick, replicas) {sizes}; scale-up decision to "
        f"registered s {out['scale_up_s']}; client TTFT p50/p99 "
        f"{rep['ttft_p50_s']}/{rep['ttft_p99_s']} s, TPOT p50/p99 "
        f"{rep['tpot_p50_s']}/{rep['tpot_p99_s']} s (from SSE text deltas: "
        f"None when no token streamed text), e2e p50/p99 {rep['e2e_p50_s']}/{rep['e2e_p99_s']} s; the "
        f"engines' request logs ({rep['engine_requests']} requests): TTFT "
        f"p50/p99 {rep['engine_ttft_p50_s']}/{rep['engine_ttft_p99_s']} s, "
        f"TPOT p50/p99 {rep['engine_tpot_p50_s']}/"
        f"{rep['engine_tpot_p99_s']} s; drains "
        f"{[(d['name'], d['ok'], d['resumed']) for d in rep['drains']]}; "
        f"journal entries left live {rep['journal_leftover']}")
    if rep["errors"] or rep["completed"] != rep["requests"]:
        fail(f"fleet: closed loop: {rep['errors']} of {rep['requests']} "
             "requests failed")
    if [t for _, t in sizes] != [1, 2, 1]:
        fail(f"fleet: closed loop: replicas went {sizes}, not 1 -> 2 -> 1")
    if not rep["drains"] or not all(d["ok"] for d in rep["drains"]):
        fail(f"fleet: closed loop: drains {rep['drains']}")
    if rep["journal_leftover"]:
        fail(f"fleet: closed loop: {rep['journal_leftover']} journal "
             "entries left live")
    return out


def _fleet_models(torch, fleet_mod, base: str, models, device: str,
                  card: str) -> dict:
    """Two models under a budget that holds one, each at its real fp32
    weight bytes: `ensure` on the second drains and evicts the first. The
    first's child is profiled while it serves (B2 and B3 in its trace)."""
    on_card = device != "cpu"
    entries = []
    for label, hf, model_dir in models:
        entries.append((label, model_dir, _weight_bytes(hf, FLEET_LAYERS)))
    budget = max(w for _, _, w in entries) * 3 // 2
    profile_dir = os.path.join(base, "profiles")
    fleet = fleet_mod.ModelFleet(None, pathlib.Path(base) / "fleet", budget,
                                 device=device)

    def engine_args_for(model_dir):
        def engine_args(port, name, journal_dir):
            return ["--model-dir", model_dir, "--random-weights",
                    "--dtype", "float32", "--host", "127.0.0.1",
                    "--port", str(port), "--max-slots", "2",
                    "--kv-block", str(FLEET_KV_BLOCK),
                    "--kv-blocks", str(FLEET_LOOP_KV_BLOCKS),
                    "--prefix-cache-mb", "8", "--drain-grace", "30",
                    "--journal", str(journal_dir),
                    "--journal-fsync", "always", "--debug-endpoints",
                    "--profile-dir", profile_dir]
        return engine_args
    for label, model_dir, weight in entries:
        fleet.register_model(label, weight, engine_args_for(model_dir))

    def free():
        return torch.cuda.mem_get_info()[0] if on_card else 0
    out = {"budget_bytes": budget,
           "weight_bytes": {lb: w for lb, _, w in entries}, "models": {}}
    free0 = free()
    pools = {}
    try:
        for i, (label, _, weight) in enumerate(entries):
            t0 = time.monotonic()
            pool = pools[label] = fleet.ensure(label)
            secs = time.monotonic() - t0
            member = pool._members[0]
            url = member.proc.url
            res = {"ensure_s": secs, "ready_s": list(member.proc.ready_s),
                   "resident": fleet.resident_models(),
                   "card_bytes": free0 - free()}
            st, _, _ = _http(url + "/v1/completions", "POST", {
                "prompt": "abcdefgh", "max_tokens": 40, "temperature": 0.0})
            if st != 200:
                fail(f"fleet: {label}: completion HTTP {st}")
            m = _scrape(url)
            res["hbm_bytes_in_use"] = m.get("ome_engine_hbm_bytes_in_use")
            res["weights_tenant_bytes"] = m.get(
                'ome_engine_hbm_tenant_bytes{tenant="weights"}')
            if i == 0:
                if on_card:
                    res["profile"] = _fleet_profile(url)
                res["class_preemption"] = _fleet_class_probe(url, card)
            out["models"][label] = res
            log(f"[fleet] model {label} ({card}): ensure {secs:.1f} s "
                f"(spawn to /health {member.proc.ready_s}), weight bytes "
                f"{weight} (the engine's weights tenant "
                f"{res['weights_tenant_bytes']}), card bytes taken "
                f"{res['card_bytes'] / GiB:.3f} GiB, allocator bytes in use "
                f"{(res['hbm_bytes_in_use'] or 0) / GiB:.3f} GiB, resident "
                f"{res['resident']}")
        events = [(e.kind, e.model, e.freed_bytes) for e in fleet.events]
        out["events"] = events
        first, second = entries[0][0], entries[1][0]
        if events != [("spawn", first, 0), ("evict", first, entries[0][2]),
                      ("spawn", second, 0)] or \
                fleet.resident_models() != [second]:
            fail(f"fleet: ensure({second}) did not evict {first}: {events}, "
                 f"resident {fleet.resident_models()}")
        out["evicted_drains"] = [vars(r) for r in pools[first].drains]
        if not out["evicted_drains"] or \
                not all(r["ok"] for r in out["evicted_drains"]):
            fail(f"fleet: the eviction's drain: {out['evicted_drains']}")
    finally:
        fleet.stop_all()
    if on_card:
        deadline = time.monotonic() + 60
        while free0 - free() > GiB and time.monotonic() < deadline:
            time.sleep(0.5)
        out["card_bytes_after"] = free0 - free()
        log(f"[fleet] after the fleet stopped ({card}): card free bytes "
            f"{out['card_bytes_after'] / GiB:.3f} GiB below their value "
            f"before the first spawn")
        if out["card_bytes_after"] > GiB:
            fail(f"fleet: the card's free memory did not come back: "
                 f"{out['card_bytes_after'] / GiB:.2f} GiB short")
    return out


def _fleet_class_probe(url: str, card: str) -> dict:
    """Two tenants on one fleet child (two slots, no KV pressure): four
    batch requests fill both slots, then two interactive requests
    arrive. Batch holds more than its weight share of the slots, so the
    scheduler preempts one batch request for each interactive one (the
    recompute fold, its flight event `preempt_class`), and every request
    still finishes."""
    def send(i, prio, n):
        t0 = time.monotonic()
        st, _, raw = _http(url + "/v1/completions", "POST", {
            "prompt": f"tenant {prio} {i} abcdefgh", "max_tokens": n,
            "temperature": 0.0, "priority": prio})
        body = json.loads(raw) if st == 200 else {}
        done[(prio, i)] = (st, time.monotonic() - t0,
                           (body.get("choices") or [{}])[0].get(
                               "finish_reason"))
    done = {}
    threads = [threading.Thread(target=send, args=(i, "batch", 96))
               for i in range(4)]
    for t in threads:
        t.start()
    time.sleep(0.3)
    late = [threading.Thread(target=send, args=(i, "interactive", 16))
            for i in range(2)]
    for t in late:
        t.start()
    for t in threads + late:
        t.join(timeout=300)
    st, _, raw = _http(url + "/debug/events?n=2048")
    events = json.loads(raw).get("events", []) if st == 200 else []
    kinds = collections.Counter(e.get("event") for e in events)
    out = {"requests": {f"{p} {i}": v for (p, i), v in sorted(done.items())},
           "preempt_class": kinds["preempt_class"],
           "preempt_fold": kinds["preempt_fold"]}
    log(f"[fleet] two tenants on one child ({card}): class preemptions "
        f"{out['preempt_class']}, KV-pressure preemptions "
        f"{out['preempt_fold']}; (status, seconds, finish) per request "
        f"{out['requests']}")
    if len(done) != 6 or any(v[0] != 200 or v[2] not in ("length", "stop")
                             for v in done.values()):
        fail(f"fleet: two tenants: {out['requests']}")
    if out["preempt_class"] < 1:
        fail("fleet: two tenants: no batch request was preempted for the "
             f"interactive ones (GET /debug/events HTTP {st})")
    return out


FLEET_TRACE_KERNELS = {"flash_prefill": r"prefill_(?:wgmma|f32)",
                       "flash_paged_decode":
                           r"decode_(?:tc|scalar)<[^>]*\btrue>"}


def _fleet_profile(url: str) -> dict:
    """POST /debug/profile on a fleet child, with a request in flight
    until the capture answers (the child's first capture opens its 2 s
    window only once torch.profiler has started, which imports
    torch._dynamo: seconds): the child's own trace, B2 and B3 counted by
    their kernels' names."""
    got = {}

    def capture():
        got["res"] = _http(url + "/debug/profile?seconds=2", "POST")
    t = threading.Thread(target=capture)
    t.start()
    served, n = None, 0
    try:
        time.sleep(0.3)
        while t.is_alive() and served in (None, 200):
            served, _, _ = _http(url + "/v1/completions", "POST", {
                "prompt": f"a b c d e f {n}", "max_tokens": 48,
                "temperature": 0.0})
            n += 1
    finally:
        t.join(timeout=300)
    st, _, raw = got.get("res", (None, None, b"{}"))
    res = json.loads(raw) if st == 200 else {}
    if st != 200 or not res.get("captured") or \
            not os.path.exists(res.get("trace", "")):
        fail(f"fleet: POST /debug/profile: HTTP {st} {raw[:200]!r}")
    with open(res["trace"]) as f:
        events = json.load(f).get("traceEvents", [])
    os.remove(res["trace"])
    counts = {k: sum(1 for e in events if e.get("cat") == "kernel"
                     and re.search(p, e.get("name", "")))
              for k, p in FLEET_TRACE_KERNELS.items()}
    log(f"[fleet] a fleet child's own profile while it served: kernel "
        f"launches {counts}")
    if min(counts.values()) <= 0 or served != 200:
        fail(f"fleet: the child's trace holds no B2 or no B3 launch: "
             f"{counts} (request HTTP {served})")
    return counts


def phase_fleet(torch, card: str, device: str = "cuda",
                models=None) -> dict:
    """Phase 46: the fleet under faults and load, through the port's
    harness (`ome_tpu_torch/chaos.py`, `autoscale/`) with port engine
    children on `device`: two chaos episodes, the closed loop and two
    models under a weight budget, at the Llama-3-8B widths (and
    Qwen2.5-7B's) `FLEET_LAYERS` deep, fp32, random weights from seed 0.
    `models` and `device="cpu"` rehearse it off the card."""
    import tempfile
    from ome_tpu_torch import chaos
    from ome_tpu_torch.autoscale import controller, fleet, trace
    from ome_tpu_torch.models.config import llama3_8b
    base = tempfile.mkdtemp(prefix="ome-fleet-")
    models = models or [("Llama-3-8B", dict(_hf_config(llama3_8b()),
                                            _source="meta-llama/"
                                            "Meta-Llama-3-8B config.json")),
                        ("Qwen2.5-7B", QWEN25_7B)]
    dirs = [(label, hf, _fleet_model_dir(base, hf, FLEET_LAYERS))
            for label, hf in models]
    free0 = torch.cuda.mem_get_info()[0] if device != "cpu" else 0
    out = {}
    try:
        out["chaos"] = _fleet_chaos(chaos, trace, base, dirs[0][2], device,
                                    card)
        out["closed_loop"] = _fleet_closed_loop(controller, trace, base,
                                                dirs[0][2], device, card)
        out["models"] = _fleet_models(torch, fleet, base, dirs, device, card)
    finally:
        import shutil
        shutil.rmtree(base, ignore_errors=True)
    if out["chaos"]["unified"]["preemptions"] + \
            out["chaos"]["pd"]["preemptions"] <= 0:
        fail("fleet: the 3-block pools never preempted: the recompute "
             "path did no work")
    if device != "cpu":
        short = free0 - torch.cuda.mem_get_info()[0]
        out["card_bytes_short_at_end"] = short
        if short > GiB:
            fail(f"fleet: the card's free memory is {short / GiB:.2f} GiB "
                 "below its value before the phase's first spawn")
    return out


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


def _warm_ledger(torch) -> None:
    """The ledger counter's set-up, and the import of torch._dynamo that
    torch.profiler's first start pays (the profiled phases' windows)."""
    import torch._dynamo  # noqa: F401
    from ome_tpu_torch.perf.ledger import ProgramLedger
    ProgramLedger(device=torch.device("cuda")).prepare()


def main() -> int:
    t0 = time.monotonic()
    import torch
    card = phase_device(torch)
    from ome_tpu_torch.models.config import llama3_8b
    report = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda}
    phase_s = report["phase_s"] = {}

    def run(key, fn, *a, free=None, **kw):
        t = time.monotonic()
        report[key] = fn(*a, **kw)
        phase_s[key] = time.monotonic() - t
        log(f"[phase] {key}: {phase_s[key]:.1f} s")
        if free:
            _free_device(torch, free)
    # the ledger's counter set-up and torch.profiler's first-start import
    # run while nvcc builds the kernels, not inside phase 4
    warm = threading.Thread(target=_warm_ledger, args=(torch,))
    warm.start()
    run("build", phase_build)
    warm.join()
    run("kernel_cases", phase_kernels, torch)
    run("headdim_kernels", phase_headdim_kernels, torch)
    run("serve", phase_serve, torch, attribution=True,
        free="the dense server")
    run("paged_bf16", phase_serve_paged, torch, "bf16",
        free="the paged bf16 server")
    run("paged_int8", phase_serve_paged, torch, "int8",
        first_tokens=report["paged_bf16"]["first_tokens"],
        free="the paged int8 server")
    run("serve_int4", phase_serve, torch, quantization="int4",
        model={"hf": _hf_config(llama3_8b()), "label": "Llama-3-8B",
               "layers": CUT_LAYERS}, free="the int4 server")
    run("step_turns", phase_step_turns, torch,
        free="the step-time engines")
    run("quant_turns", phase_quant_turns, torch,
        free="the weight-quantization engines")
    run("stream_identity", phase_stream_identity, torch,
        free="the stream-identity engines")
    run("checkpoint", phase_checkpoint, torch, free="the checkpoint")
    run("weight_plane", phase_weight_plane, torch, card,
        report["checkpoint"], free="the weight-plane server")
    run("step_plans", phase_step_plans, torch,
        free="the step-plan engines")
    run("serve_spec", phase_serve_stepplan, torch, False,
        before=report["serve"], free="the spec server")
    run("serve_spec_paged", phase_serve_stepplan, torch, True,
        before=report["paged_bf16"], free="the paged spec server")
    qwen = {"hf": QWEN25_7B, "label": "Qwen2.5-7B", "bias_std": 0.5}
    run("serve_qwen25_7b", phase_serve, torch, model=qwen,
        free="the Qwen2.5-7B server")
    run("paged_qwen25_7b", phase_serve_paged, torch, "bf16", model=qwen,
        free="the paged Qwen2.5-7B server")
    run("qwen3_identity", phase_qk_norm_identity, torch,
        free="the Qwen3-width engines")
    run("serve_mixtral", phase_serve, torch,
        model={"hf": MIXTRAL_8X7B, "label": "Mixtral-8x7B",
               "layers": MIXTRAL_SERVED_LAYERS},
        free="the Mixtral server")
    run("mixtral_identity", phase_moe_identity, torch,
        free="the Mixtral-width engines")
    run("mqa_kernels", phase_mqa_kernels, torch)
    run("mqa_identity", phase_mqa_identity, torch,
        free="the G 32 engines")
    run("host_tier", phase_host_tier, torch, free="the host-tier server")
    run("pd", phase_pd, torch, free="the PD servers")
    run("peering", phase_peering, torch, free="the peering replicas")
    run("router", phase_router, torch, free="the routed replicas")
    phi3 = {"hf": PHI3_MINI_4K, "label": "Phi-3-mini-4k"}
    run("serve_phi3", phase_serve, torch, model=phi3,
        free="the Phi-3-mini server")
    run("paged_phi3", phase_serve_paged, torch, "bf16", model=phi3,
        kv_block=64, free="the paged Phi-3-mini server")
    run("phi3_identity", phase_phi3_identity, torch,
        free="the Phi-3-width engines")
    run("journal", phase_journal, torch)
    run("lora_identity", phase_lora_identity, torch,
        free="the multi-LoRA identity engines")
    run("lora_server", phase_lora_server, torch,
        free="the multi-LoRA server")
    run("embed", phase_embed, torch, free="the embedding engines")
    run("family_kernels", phase_family_kernels, torch)
    run("family_identity", phase_family_identity, torch)
    for key, model in FAMILY_SERVERS:
        run(key, phase_serve, torch, model=model,
            free=f"the {model['label']} server")
    run("mla_identity", phase_mla_identity, torch)
    run("mla_checkpoint", phase_mla_checkpoint, torch,
        free="the DeepSeek checkpoint")
    run("mla_pd", phase_mla_pd, torch, free="the DeepSeek PD servers")
    for key, model, quantization in MLA_SERVERS:
        run(key, phase_serve_mla, torch, model, quantization,
            free=f"the {model['label']} {quantization} server")
    run("mla_int4_kernel", phase_mla_int4_kernel, torch)
    run("tp_kernels", phase_tp_kernels, torch)
    run("tp_identity", phase_tp_identity, torch,
        free="the tp identity engines")
    run("serve_tp", phase_serve_tp, torch, before=report["serve"],
        free="the tp 2 server")
    run("tp_lws", phase_tp_lws, torch)
    run("train", phase_train, torch, free="the training phase")
    run("fleet", phase_fleet, torch, card)
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
    # at head_dim 96 the Phi-3-mini servers' (dense: B1, B2; paged: B3);
    # at 256 the Gemma-2-9B server's (B1, B2; paged KV is refused for
    # Gemma 2, as in the reference)
    d96 = dict(report["serve_phi3"]["launches"])
    d96["flash_paged_decode"] = report["paged_phi3"]["launches"][
        "flash_paged_decode"]
    d96["flash_decode_quantized"] = 0
    d256 = dict(report["serve_gemma2_9b"]["launches"])

    def entry(name, label, case, n):
        source, replaces = SOURCES[name]
        return {"name": label, "route": "cuda", "source": source,
                "replaces": replaces, "launches": n,
                "max_abs_err": case["max_abs_err"], "ms": case["ms"],
                "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
                "bound_by": case["bound_by"],
                "library_ms": case["library_ms"]}
    kernels = [entry(name, name, report["kernel_cases"][name][0],
                     launches[name]) for name in SOURCES]
    # (the first case of each D: at D 96 B3's is the served shape)
    for name, rows in report["headdim_kernels"].items():
        for D, n in ((96, d96[name]), (256, d256[name])):
            case = next(c for c in rows if f" D={D} " in c["case"])
            kernels.append(entry(name, f"{name} head_dim {D}", case, n))
    # the later families' served shapes: B1 and B2 at Gemma-2-9B's heads with
    # its window and softcap (launches: the Gemma-2-9B server), B1 at
    # command-r's G 1 (launches: its fp32 identity engines, the one run
    # of that model), B1 and B2 with gpt-oss-20b's sinks and window
    # (launches: the gpt-oss-20b server)
    fam = report["family_kernels"]
    cr = report["family_identity"]["command-r-v01"]["launches"]
    go = report["serve_gpt_oss_20b"]["launches"]

    def sink_case(name, head):
        return next(c for c in fam[name] if c["case"].startswith(head)
                    and " H=64 K=8 D=64 " in c["case"]
                    and " window=128 " in c["case"]
                    and c["case"].endswith(" sinks"))
    for name, label, case, n in (
            ("flash_decode", "flash_decode Gemma-2-9B D 256 window 4096 "
             "softcap 50", fam["flash_decode"][0], d256["flash_decode"]),
            ("flash_prefill", "flash_prefill Gemma-2-9B D 256 causal 2048 "
             "window 4096 softcap 50", fam["flash_prefill"][0],
             d256["flash_prefill"]),
            ("flash_decode", "flash_decode command-r G 1",
             fam["flash_decode"][4], cr["flash_decode"]),
            ("flash_decode", "flash_decode gpt-oss-20b D 64 sinks window "
             "128", sink_case("flash_decode", "decode bf16 "),
             go["flash_decode"]),
            ("flash_prefill", "flash_prefill gpt-oss-20b D 64 sinks causal "
             "2048 window 128", sink_case("flash_prefill",
                                          "prefill bf16 B=1 Sq=2048 "),
             go["flash_prefill"])):
        kernels.append(entry(name, label, case, n))
    # B4 at DeepSeek-V3's shapes (launches: the V3 int4 server's, by shape)
    v3 = report["serve_deepseek_v3_int4"]["int4_shapes_serving"]
    for case, (leaf, K, N) in zip(report["mla_int4_kernel"]["int4_matmul"],
                                  V3_INT4_SHAPES):
        kernels.append(entry("int4_matmul", f"int4_matmul DeepSeek-V3 {leaf} "
                             f"K {K} N {N} m 8", case, v3[f"K={K} N={N}"]))
    # B1 and B2 at the per-rank shapes of tp 2 (H 16, K 4; launches: rank
    # 0 of the tp 2 server, phase 43)
    tpk = report["tp_kernels"]
    for name in ("flash_decode", "flash_prefill"):
        H, K, D = TP_SHAPES[0]
        kernels.append(entry(name, f"{name} per rank at tp {TP} (H {H}, K "
                             f"{K}, D {D})", tpk[name][0],
                             report["serve_tp"]["launches"][name]))
    # B4 at the 8B's per-rank int4 shapes of tp 2 (launches: rank 0 of
    # phase 42's int4 group, by shape)
    t4 = report["tp_identity"]["Llama-3-8B int4"]["int4_by_shape_rank0"]
    for case, (leaf, K, N) in zip(tpk["int4_matmul"], TP_INT4_SHAPES):
        kernels.append(entry("int4_matmul", f"int4_matmul per rank at tp "
                             f"{TP} (Llama-3-8B {leaf} K {K} N {N} m 8)",
                             case, t4[f"K={K} N={N}"]))
    # B2's backward at the 8B case: bf16 on the wgmma kernel (launches:
    # the 8B-width training steps), fp32 on the scalar one (launches, its
    # own count: the fp32 identity step through the kernels)
    train = report["train"]
    for case, label, source, n in (
            (train["flash_prefill_bwd"][0], "flash_prefill_bwd",
             "flash_prefill_bwd_wgmma.cu",
             train["step"]["launches"]["flash_prefill_bwd"]),
            (train["flash_prefill_bwd"][1], "flash_prefill_bwd fp32",
             "flash_prefill_bwd.cu",
             train["identity"]["launches_kernels"]["flash_prefill_bwd_fp32"])):
        kernels.append({
            "name": label, "route": "cuda",
            "source": f"ome_tpu_torch/ops/csrc/{source}",
            "replaces": "ome_tpu/ops/attention.py:139",
            "launches": n, "max_abs_err": case["max_abs_err"],
            "ms": case["ms"], "plain_ms": case["plain_ms"],
            "bound_ms": case["bound_ms"], "bound_by": case["bound_by"],
            "library_ms": case["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--tp-follower"]:
        # rank 1 of phase_tp_identity, started by it
        sys.exit(tp_follower(json.loads(sys.argv[2])))
    sys.exit(main())
