"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py            # the full check, one card

    python3 chip_smoke.py --paths serve --serve-tiny   # short first call
    python3 chip_smoke.py --replicas 512 --flat-replicas 512   # short
    python3 chip_smoke.py --paths workflow,flat_k8
    python3 chip_smoke.py --paths traced --traced-replicas 512   # short
    python3 chip_smoke.py --paths stream --stream-replicas 512   # short
    python3 chip_smoke.py --paths flat,chunked --flat-replicas 512 \
        --chunked-replicas 1280 --chunk 512                        # short
    python3 chip_smoke.py --paths learned,es
    python3 chip_smoke.py --paths learned,es --learned-replicas 512 \
        --es-generations 2                                         # short
    python3 chip_smoke.py --paths serve_gemma --serve-tiny         # short
    python3 chip_smoke.py --paths serve_xlstm,serve_wide,frontends \
        --serve-tiny                                               # short
    python3 chip_smoke.py --paths train                  # training
    python3 chip_smoke.py --paths train --train-tiny     # short

Phases (any failure exits non-zero; there is no CPU fallback):
  1. device: the card's name and power limit;
  2. build: nvcc builds the five CUDA libraries from
     ``src/repro_torch/kernels/csrc``, one nvcc each, all at once;
  3. kernels: each kernel against its plain PyTorch version on the card:
     the five scheduling kernels bitwise, on random and edge-case inputs
     (both layouts of ``masked_argmin``, ``fused_minmin``,
     ``fused_maxmin`` and ``fused_start_pick``), each case launched twice
     and the two results bitwise equal; the learned policies'
     multiply-add (``fma``) bitwise its plain version on the card and on
     the CPU, on the forward pass's broadcast shapes at R = 4096, signed
     zeros, subnormal results and the queue C probe (a product below half
     an ulp of the sum);
     flash attention at atol = rtol = 2e-5 (f32) / 2e-2 (bf16) and the
     grouped matmul at atol = 2e-5 D, rtol = 2e-5 (f32) / 2e-2 D, 2e-2
     (bf16) with its padding rows exactly 0 (the tolerances of
     ``tests/test_kernels.py``), each model-kernel case launched twice
     and the two results bitwise equal; flash attention also at the
     serve_gemma path's shapes, f32 16 x 2048 x 256 causal with window
     1024 and 10 x 2048 x 256 causal with window 2048, non-causal with
     Sq = Sk, Sq < Sk and one query at head widths 64 and 96, and in f32
     at the seamless encoder's 16 x 1024 x 1024 x 64 (non-causal), its
     cross-attention (512 queries against 1024 frames; one query), its
     decoder's causal prefill, phi-3-vision's 32 x 1024 x 96 and the 64
     x 1024 x 128 prefill of command-r, qwen2-72b and qwen3-moe; the
     grouped matmul also at qwen3-moe's G = 128 experts, d 4096 -> 3072
     and 1536 -> 4096, at a 1024-token prefill (C = 80) and a decode
     step (8 live groups of one row); the flash backward
     (``flash_attention_bwd``, three kernels) against its plain twin at
     max|dX - dX_ref| <= 1e-4 max|dX_ref| (f32) and 2e-2 (bf16) for
     each of dq, dk, dv, each case launched twice with bitwise-equal
     results and the forward with ``lse`` bitwise the forward without:
     the train path's causal 24 x 4096 x 128 in bf16 and f32, causal
     with window 1024 and softcap 50 at hd 256, the same with softcap 5
     on logits of std 4 (where a missing 1 - tanh^2 shows), non-causal
     with Sq = Sk and Sq < Sk, head widths 64, 96, 37 and 100, S = 1000,
     rows with no visible key; a flash call under grad has a ``grad_fn`` whose
     backward launches the kernels, and the grouped matmul refuses grad
     on the card;
  4. main paths, each driven through its entry point with the launch
     counts set to 0 just before it and read just after, every kernel of
     the path launched, and kernel inputs captured from the run
     re-checked against the plain versions:
       flat      ``run_experiment``, 4096 replicas x 512 tasks x 32
                 machines, ten policies (``--tasks``: 512 for the time
                 limit, 1024 before the train path);
       scenario  the same width with a ``ScenarioAxis`` (fail rates 0,
                 0.05, 0.1 x DVFS nominal, powersave, turbo, half the
                 replicas on spot machines), ten policies;
       workflow  the same width in workflow mode: chain and layered DAGs
                 (``WorkloadAxis(shapes=...)``), fail rates 0 and 0.05,
                 ten paired policies (410 cells); every task terminal,
                 precedence held (no task starts before its parents'
                 last end), cascade cancels present;
       flat_k8   the flat spec with ``SimParams(drain_k=8)``: its final
                 state bitwise the K = 1 flat run's on the card;
       traced    the scenario spec with ``trace=True, metrics=True``:
                 every final state bitwise the untraced scenario run's,
                 the same host reads, no trace overflowed, per replica N
                 terminal rows and every start row closed by a later
                 row of its task, the histograms and SLO windows summing
                 to the completed and missed counts and the queue-depth
                 samples to the event count; one replica's HTML report
                 and telemetry dashboard written under ``build/``;
       stream    ``run_experiment`` with ``WorkloadAxis(1024,
                 streaming=256, stream_chunk=64)``: the flat spec's
                 draws, 4096 replicas x 1024 tasks through a 256-slot
                 window x 32 machines, ten policies; every replica
                 retires every task with none stalled and none live,
                 the outcome counts sum to the retired, every host read
                 is a drain's (one a drain chunk) and the window engine
                 synchronises with the host only at those reads
                 (``torch.cuda.set_sync_debug_mode``), the path's own
                 peak device memory (its normalized inputs counted,
                 earlier paths' captured kernel inputs not) beside the
                 flat path's;
       chunked   ``run_experiment(chunk=4096, keep_replicas=True)`` on the
                 flat spec at 8192 replicas (two chunks of 4096;
                 ``launch/chunked.py``), telemetry on: the kept
                 rows of the first chunk bitwise the flat path's
                 summaries, ``aggregate_metrics`` of the kept columns on
                 the card bitwise the run's ``SweepAgg``, the replicas
                 of each policy counted, the path's own peak device
                 memory at most 1.25x the flat path's, and its
                 host-synchronising operations only the engine's host
                 reads (``Plan.make``'s set-up apart), one a chunk at
                 retirement and the final
                 read of the aggregate; ``ChunkedStats`` and the seconds
                 of each chunk beside the flat path's execute seconds;
       learned   ``run_experiment`` of the flat spec's draws at 4096
                 replicas x 512 tasks x 32 machines with
                 ``PolicyAxis(("mlp", "linear"))`` and shared random
                 weights (``neural.init_params(0)``, drawn on the host):
                 the path launches ``masked_argmin``, ``fused_start_pick``,
                 ``fused_event_bounds`` and ``fma`` (every multiply-add of
                 the features and the forward pass), and every task ends
                 terminal;
       es        ``learn.train_and_evaluate`` at the repo's documented
                 full configuration (24 training and 24 held-out
                 scenarios, 64 tasks x 8 machines, pop 12), generations
                 cut to ``--es-generations`` for the time limit: each
                 generation one ``run_sweep`` of 25 x 24 = 600 replicas
                 (counted), then the scoreboard of the nine baselines and
                 the trained ``mlp`` (ten rows) in one sweep, written
                 with its SVG under ``build/learned/``; every scheduling
                 kernel launched (the baselines run Min-Min and Max-Min),
                 ``fma`` too;
       serve     ``ServingEngine(run_mode="real")``, ee_mct over 4
                 machines of 2 types, 8 Poisson requests of two apps:
                 qwen2-1.5b as published (28 layers) and deepseek-moe-16b
                 at its published widths cut to 8 layers (1 dense + 7
                 MoE), random f32 weights from a seeded generator,
                 prompt 1024 and 32 generated tokens; every request
                 completes and each model kernel launches exactly as
                 often as the shapes imply;
       serve_gemma  the same engine, fleet and policy serving
                 gemma3-12b and recurrentgemma-2b as published (48
                 layers, 5 local : 1 global, window 1024, QK-norm and
                 sandwich norms; 26 layers, 8 cycles of (rec, rec, local)
                 and 2 ``rec`` layers, window 2048), random f32 weights
                 (some 47 and 11 GB, drawn after the serve path's are
                 freed), 8 Poisson requests, prompt 2048 (past gemma's
                 window) and 32 generated tokens (both rings wrap); every
                 request completes and flash attention launches once per
                 attention layer of each prefill;
       serve_xlstm  the same engine, fleet, policy and requests serving
                 xlstm-350m as published (24 layers, 6 x (mlstm, mlstm,
                 mlstm, slstm), LayerNorm, tied embeddings) and
                 qwen2-72b at its published widths cut to 4 of 80 layers
                 (d 8192, QKV bias), prompt 1024 and 32 tokens; no flash
                 launch for an xLSTM layer;
       serve_wide  the same, command-r-35b at its published widths cut
                 to 4 of 40 layers (parallel blocks, LayerNorm, tied
                 vocab 256000) and qwen3-moe-235b-a22b cut to 2 of 94
                 (128 experts, top-8, QK-norm): the grouped matmul at
                 G = 128;
       frontends  ``models/model.py`` ``prefill`` and ``decode_step``
                 called directly (the engine passes tokens alone, as the
                 reference's does), 2 requests of each app, prompt 1024
                 and 32 tokens: seamless-m4t-large-v2 as published (24
                 encoder + 24 decoder layers) over 1024 seeded frames of
                 width 1024 (the encoder's non-causal flash, the
                 decoder's cross-attention flash at prefill and at each
                 decode step) and phi-3-vision-4.2b as published (32
                 layers) with 576 seeded patch embeddings spliced over
                 its first positions; every request's tokens in the
                 vocabulary and its last logits finite;
       train     ``launch/train.py``: qwen2-1.5b as published (28
                 layers), bf16 compute with the f32 master and moments,
                 remat on, random weights from seed 0 with the zero
                 leaves noised, the port's synthetic ``TokenStream`` at
                 ``train_4k``'s 4096 tokens, 8 sequences a step (cut
                 from its 256) in 4 microbatches of 2, ``AdamWConfig()``
                 with warmup 2: one ``loss_fn`` gradient of a
                 microbatch first (every parameter leaf finite and
                 nonzero), then 4 steps of ``build_train_step`` (loss,
                 grad_norm, update_skipped = 0, seconds, tokens/s, peak
                 memory each), flash forward and backward launches as
                 the shapes imply (remat runs the forward twice), then
                 one profiled step (idle share, top device operations);
  5. card vs CPU (run last, after phase 6, so that no timed or profiled
     window shares the card or the host with it; phase 6 read lost
     profiler records when it ran after this phase): a
     64 x 128 x 8 flat sweep, scenario sweep, workflow
     sweep (all four DAG shapes) and flat sweep at K = 8 on the card and
     on the CPU must give bitwise-equal final states and summaries; with
     the stream path, the streaming flat spec at W = 32 (overflow) and
     W = 128 = N (its window also bitwise the dense flat run's final
     state), the streaming scenario spec at W = 32, ``simulate_stream``
     of a chain and of a fork-join workflow above ``min_window`` and the
     W = 32 flat spec traced with metrics, every window field, summary
     column, trace row and count bitwise equal to the CPU run's; with
     the traced path, flat, scenario and workflow traced with metrics
     bitwise-equal trace rows, snapshots, counts and tail columns, and a
     registered user policy in a mixed-id sweep bitwise the CPU run, its
     machine pick one ``masked_argmin`` launch a drain trip; with the
     chunked path, ``run_experiment(chunk=...)`` of the flat, scenario,
     workflow (all four shapes; a chunk of 24 splits a cell of ten
     paired policies) and streaming (W = 32) specs at 64 x 128 x 8 in
     chunks of 24, and of docs/scaling.md's 3000-replica cell in chunks
     of 1000, every ``SweepAgg`` field bitwise equal to the CPU's fold
     of its whole run, whose columns the kept ones equal; with the
     learned path, ``mlp`` and ``linear`` with random weights on the flat
     spec, at K = 8 (against the CPU's K = 1 run, which the port's K-way
     drain equals), on the scenario spec and through the streaming
     (W = 32) and chunked (chunks of 24) paths, every state field,
     window field, summary column and ``SweepAgg`` field bitwise equal to
     the CPU run's, and the warm starts on the card: ``mlp`` with
     ``ee_mlp_params`` bitwise ``ee_mct``, with ``mct_mlp_params``
     bitwise ``mct``; with the es path, one ES generation at pop 3 on a
     4-scenario grid, its fitness values, theta' and best theta bitwise
     equal to the CPU's; the
     tiny configurations of both apps of each serving path through the
     same driver (the ``ServingEngine``; for frontends the direct calls)
     on both (a prompt of 40 past the tiny window
     of 16, 6 tokens past the ring's wrap), the card teacher-forced with
     the CPU's tokens, must agree on every logit to atol = rtol = 1e-4
     and on the greedy token wherever the CPU's top-2 margin exceeds
     1e-3; with the train path, tiny qwen2-1.5b in f32 (zero leaves
     noised, 4 x 64 tokens, remat): the loss within 1e-5 relative and
     every gradient leaf within 1e-4 of its largest value of the CPU
     port's, and ``adamw_update`` on the card fed the CPU's gradients
     equal to the CPU's at rtol 1e-6;
  6. timings: each kernel, its plain version and, where one PyTorch call
     computes the same function, that call, on the inputs of the
     captured main-path call with the most work, rotated over copies
     larger than the L2 cache: device time (profiler) and stream time
     (CUDA events), beside the least time the card could take for that
     call's data (see ``bound``, ``model_bound`` and ``fma_bound``; the
     model kernels' row also lists every captured call); for the
     scheduling kernels also the host time per call of each wrapper (5
     rounds of 1000 calls, no synchronisation) and the launch floor: an
     empty kernel at the kernel's grid, timed the same ways; for the
     flash backward, at the train path's captured shape in bf16 and
     again in f32, the kernel, its plain twin and autograd through
     ``scaled_dot_product_attention`` (its backward only).  The flash
     rows' library call is SDPA on 4-D views with its fused kernel
     pinned (``sdpa``): FlashAttention-2 in bf16, the memory-efficient
     kernel in f32.
After 4 a profiled window of each path (the sweeps' first 32 event
steps, the workflow path's first 8, the chunked path's at 2048 replicas
in two chunks of 1024 with their normalization, the learned path's
first 32; one request of each app, one app at a time; the train path's
fifth step) gives the device's busy and idle share.
The workflow path's fork-join and map-reduce shapes run only in phase 5:
at 1024 tasks they pad every parent table to K = 1022 (17 GB at 4096
replicas) and their ranks take an N x K host loop a cell.
The last two lines are the kernels JSON line and the result line.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

POLICIES = ("fcfs", "rr", "met", "mct", "ee_met", "ee_mct", "minmin",
            "maxmin", "edf_mct", "heft")
SCENARIO = dict(fail_rates=(0.0, 0.05, 0.1),
                dvfs_states=("nominal", "powersave", "turbo"),
                spot_frac=0.5)
WORKFLOW_SCENARIO = dict(fail_rates=(0.0, 0.05))
SHAPES = ("chain", "layered")         # the workflow path at full width
ALL_SHAPES = ("chain", "fork_join", "map_reduce", "layered")   # phase 5
PATHS = ("flat", "scenario", "workflow", "flat_k8", "traced",
         "stream", "chunked", "learned", "es")                  # sweeps
LEARNED = ("mlp", "linear")   # the learned path's policies
# the kernels a path must launch (default: all five scheduling kernels)
PATH_KERNELS = {"learned": ("masked_argmin", "fused_start_pick",
                            "fused_event_bounds")}
# the es path: launch/learn.py's full configuration, generations cut
ES_GRID = dict(n_train=24, n_test=24, n_tasks=64, n_machines=8)
ES_POP = 12
ES_GENERATIONS = 6
STREAM_TASKS = 1024           # the stream path's tasks, 4 windows
STREAM_WINDOW = 256           # its live-task window
STREAM_CHUNK = 64             # its arrival chunk
CHUNKED_PROFILE = (2048, 1024)   # the chunked profile's replicas, chunk
# the workflow path's first 32 steps launch some 670000 device
# activities, whose profiler records take 2.5 min to read: 8 steps
WORKFLOW_PROFILE_STEPS = 8
# profiled serving windows a request, at most: deepseek's and seamless's
# windows lose 1-10 of their records about one time in five, with or
# without the backward checks before them
PROFILE_TRIES = 5
SERVE_PATHS = ("serve", "serve_gemma", "serve_xlstm", "serve_wide",
               "frontends")                # the model paths
FRONTENDS = "frontends"     # the model path driven without the engine
FRONTEND_REQUESTS = 2       # its requests of each app
ALL_PATHS = PATHS + SERVE_PATHS + ("train",)
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
TF32X3_OPS_PER_S = 495e12 / 3  # f32 products as 3xTF32 on the tensor cores
BF16_OPS_PER_S = 989e12       # H100 SXM bf16 tensor cores, dense
SECTOR = 32                   # bytes the memory system moves at least
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/sched_argmin.cu"
FMA_SOURCE = "src/repro_torch/kernels/csrc/fma.cu"
FMA_PATHS = ("learned", "es")   # the paths whose forward pass launches fma
MODEL_KERNELS = ("flash_attention", "grouped_matmul")
MODEL_SOURCE = "src/repro_torch/kernels/csrc/{}.cu"
REPLACES = {
    "flash_attention": "src/repro/kernels/flash_attention.py:92",
    "grouped_matmul": "src/repro/kernels/grouped_matmul.py:50",
    "masked_argmin": "src/repro/kernels/sched_argmin.py:89",
    "fused_minmin": "src/repro/kernels/sched_argmin.py:227",
    "fused_maxmin": "src/repro/kernels/sched_argmin.py:427",
    "fused_start_pick": "src/repro/kernels/sched_argmin.py:315",
    "fused_event_bounds": "src/repro/kernels/sched_argmin.py:388",
    # no Pallas kernel: XLA's fused multiply-adds of the learned forward
    # pass (mlp_scores; linear_scores at :203, the features at :163)
    "fma": "src/repro/core/neural.py:197",
}
CAPTURE_AT = (1, 40, 400, 4000)


T0 = time.perf_counter()


def log(phase: str, msg: str) -> None:
    """A line of the run's log, behind the seconds since the start."""
    print(f"{time.perf_counter() - T0:7.1f} s [{phase}] {msg}", flush=True)


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# kernel vs plain version
# ---------------------------------------------------------------------------
def bits(x: torch.Tensor) -> torch.Tensor:
    """Bit pattern of a tensor, so that -0.0 and +0.0 compare unequal."""
    if x.dtype == torch.float32:
        return x.view(torch.int32)
    return x.to(torch.int32)


def compare(name: str, got: tuple, want: tuple) -> float:
    """Raise unless every output is bitwise equal; returns the largest
    absolute difference of the float outputs (0.0 when equal)."""
    err = 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape or not torch.equal(bits(g), bits(w)):
            bad = (bits(g) != bits(w)).nonzero()[:5].tolist()
            raise AssertionError(f"{name}: kernel != plain at {bad}")
        if g.is_floating_point():
            d = (g - w).abs()
            d = d[torch.isfinite(d)]
            err = max(err, float(d.max()) if d.numel() else 0.0)
    return err


def kernel_cases(dev):
    """(name, label, args, kwargs) cases: random shapes incl. ragged and
    single-element ones, plus the contract's edge cases."""
    g = torch.Generator(device="cpu").manual_seed(0)

    def rnd(*shape):
        return torch.rand(shape, generator=g).to(dev)

    def randint(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=g,
                             dtype=torch.int32).to(dev)

    cases = []
    # masked_argmin: (R, N, M) values + mask; the engine's (R, 1, M) rows
    # and len = N*M either side of the warp/CTA threshold (1024), with
    # and without len % 4 == 0
    for r, n, m in ((4096, 1, 32), (64, 1024, 32), (7, 33, 5), (3, 1, 1),
                    (6, 1, 30), (5, 1, 1023), (5, 32, 32), (5, 1, 1025),
                    (3, 64, 33)):
        v = (rnd(r, n, m) * 8).floor() * 0.5      # many duplicate minima
        cases.append(("masked_argmin", f"random {r}x{n}x{m}",
                      (v, rnd(r, n, m) < 0.6), {}))
    flat = (rnd(64 * 32 + 1) * 8).floor() * 0.5
    cases.append(("masked_argmin", "rows off a 16-byte boundary",
                  (flat[1:].view(64, 1, 32),
                   (rnd(64 * 32 + 1) < 0.6)[1:].view(64, 1, 32)), {}))
    v = rnd(5, 9, 4)
    cases.append(("masked_argmin", "empty mask",
                  (v, torch.zeros_like(v, dtype=torch.bool)), {}))
    v = torch.full((5, 9, 4), float("inf"), device=dev)
    mk = torch.ones_like(v, dtype=torch.bool)
    mk[:, 3, 2] = False
    cases.append(("masked_argmin", "+inf valid loses to masked BIG",
                  (v, mk), {}))
    cases.append(("masked_argmin", "valid cells >= BIG",
                  (torch.full((5, 9, 4), 2e30, device=dev), mk), {}))
    cases.append(("masked_argmin", "all cells +inf, none masked",
                  (v, torch.ones_like(mk)), {}))
    z = torch.zeros((6, 11, 3), device=dev)
    z[:, ::2] = -0.0
    cases.append(("masked_argmin", "-0.0/+0.0 ties",
                  (z, torch.ones_like(z, dtype=torch.bool)), {}))
    # fused_minmin
    for r, n, m, t in ((455, 1024, 32, 4), (5, 1000, 7, 3), (3, 1, 1, 1)):
        cases.append(("fused_minmin", f"random {r}x{n}x{m}",
                      ((rnd(r, m) * 20).floor(), rnd(r, n) < 0.5,
                       rnd(r, m) < 0.7, randint(0, t, r, n),
                       (rnd(r, t, m) * 9).floor() + 0.5), {}))
    r, n, m, t = 4, 40, 6, 3
    base = (rnd(r, m), rnd(r, n) < 0.5, rnd(r, m) < 0.7,
            randint(0, t, r, n), rnd(r, t, m))
    cases.append(("fused_minmin", "empty batch",
                  (base[0], torch.zeros_like(base[1]), *base[2:]), {}))
    cases.append(("fused_minmin", "no room",
                  (base[0], base[1], torch.zeros_like(base[2]), *base[3:]),
                  {}))
    cases.append(("fused_minmin", "all ties",
                  (torch.zeros(r, m, device=dev), torch.ones_like(base[1]),
                   torch.ones_like(base[2]), base[3],
                   torch.ones(r, t, m, device=dev)), {}))
    big = base[4].clone()
    big[:, 0, :] = 2e30
    big[:, 1, :] = float("inf")
    cases.append(("fused_minmin", "completions >= BIG and +inf",
                  (base[0], base[1], base[2], base[3], big), {}))
    cases.append(("fused_minmin", "-0.0/+0.0",
                  (torch.full((r, m), -0.0, device=dev), base[1], base[2],
                   base[3], torch.zeros(r, t, m, device=dev)), {}))
    # fused_maxmin: the Min-Min cases, and those only its two-level
    # reduction reaches
    for name, label, args, kw in [c for c in cases
                                  if c[0] == "fused_minmin"]:
        cases.append(("fused_maxmin", label, args, kw))
    signed = torch.zeros(r, t, m, device=dev)
    signed[..., ::2] = -0.0
    cases.append(("fused_maxmin", "-0.0 row minima",
                  (torch.full((r, m), -0.0, device=dev), base[1],
                   torch.ones_like(base[2]), base[3], signed), {}))
    one_b, one_r = torch.zeros_like(base[1]), torch.zeros_like(base[2])
    one_b[:, 5], one_r[:, 2] = True, True
    cases.append(("fused_maxmin", "one valid pair",
                  (base[0], one_b, one_r, base[3], base[4]), {}))
    mixed_b, mixed_r = base[1].clone(), base[2].clone()
    mixed_b[0], mixed_r[1], mixed_r[2] = False, False, True
    cases.append(("fused_maxmin", "mixed empty and full replicas",
                  (base[0], mixed_b, mixed_r, base[3], base[4]), {}))
    cases.append(("fused_maxmin", "scores below -BIG",
                  (torch.full((r, m), float("-inf"), device=dev), base[1],
                   base[2], base[3], base[4]), {}))
    # completions +0.0, -0.0, +0.0, ... along every type row: Min-Min
    # takes machine 0's +0.0, Max-Min's row minimum is -0.0
    pm = torch.zeros(r, t, m, device=dev)
    pm[..., 1::2] = -0.0
    for name in ("fused_minmin", "fused_maxmin"):
        cases.append((name, "type rows [+0.0, -0.0, ...]",
                      (torch.full((r, m), -0.0, device=dev), base[1],
                       torch.ones_like(base[2]), base[3], pm), {}))
    # both pairs either side of the per-type / per-task choice: M past one
    # warp, T = 1, T = 64, T > N, the largest type table that fits in 48
    # KB (TYPE_TABLE_MAX) and one type more, N % 4 != 0, and the captured
    # main-path call; then rows off a 16-byte boundary
    for name in ("fused_minmin", "fused_maxmin"):
        for r, n, m, t in ((6, 40, 33, 3), (6, 40, 64, 5), (6, 40, 6, 1),
                           (4, 128, 8, 64), (5, 4, 7, 9), (2, 7000, 4, 6096),
                           (2, 7000, 4, 6097), (4, 1001, 33, 3),
                           (409, 1024, 32, 4)):
            cases.append((name, f"random {r}x{n}x{m}x{t}",
                          ((rnd(r, m) * 20).floor(), rnd(r, n) < 0.5,
                           rnd(r, m) < 0.7, randint(0, t, r, n),
                           (rnd(r, t, m) * 9).floor() + 0.5), {}))
        r, n, m, t = 64, 1024, 32, 4
        cases.append((name, "rows off a 16-byte boundary",
                      ((rnd(r, m) * 20).floor(),
                       (rnd(r * n + 1) < 0.5)[1:].view(r, n),
                       rnd(r, m) < 0.7,
                       randint(0, t, r * n + 1)[1:].view(r, n),
                       (rnd(r, t, m) * 9).floor() + 0.5), {}))
    # fused_start_pick: the captured main-path shape, N % 4 != 0, the
    # most machines the per-warp tables take (PICK_WARP_MAX) and one more;
    # machines -1 and M are queued on no machine
    for r, n, m in ((4096, 1024, 32), (5, 1000, 7), (3, 1, 1), (6, 1001, 32),
                    (16, 1024, 767), (16, 1024, 768)):
        cases.append(("fused_start_pick", f"random {r}x{n}x{m}",
                      (randint(0, 8, r, n), randint(-1, m + 1, r, n),
                       randint(0, 1 << 20, r, n), m), {"in_mq": 2}))
    r, n, m = 64, 1024, 32
    cases.append(("fused_start_pick", "rows off a 16-byte boundary",
                  (randint(0, 8, r * n + 1)[1:].view(r, n),
                   randint(-1, m + 1, r, n), randint(0, 1 << 20, r, n), m),
                  {"in_mq": 2}))
    dense = torch.full((r, n), 2, dtype=torch.int32, device=dev)
    on_3 = torch.full((r, n), 3, dtype=torch.int32, device=dev)
    cases.append(("fused_start_pick", "every task queued on machine 3",
                  (dense, on_3, randint(-1000, 1000, r, n), m),
                  {"in_mq": 2}))
    cases.append(("fused_start_pick", "every task queued on machine 3 at "
                  "seq INT_MAX",
                  (dense, on_3, torch.full_like(on_3, 2**31 - 1), m),
                  {"in_mq": 2}))
    r, n, m = 4, 64, 5
    st = torch.full((r, n), 2, dtype=torch.int32, device=dev)
    cases.append(("fused_start_pick", "equal seqs (lowest id wins)",
                  (st, randint(0, m, r, n),
                   torch.full((r, n), 7, dtype=torch.int32, device=dev), m),
                  {"in_mq": 2}))
    seq = randint(0, 1 << 20, r, n)
    seq[:, 5:] = 2**31 - 1
    cases.append(("fused_start_pick", "INT_MAX seqs",
                  (randint(1, 4, r, n), randint(0, m, r, n), seq, m),
                  {"in_mq": 2}))
    cases.append(("fused_start_pick", "negative seqs",
                  (st, randint(0, m, r, n), randint(-1000, 1000, r, n), m),
                  {"in_mq": 2}))
    # fused_event_bounds
    kw = {"not_arrived": 0, "live_lo": 1, "live_hi": 3}
    for r, n in ((4096, 1024), (5, 1000), (3, 1)):
        cases.append(("fused_event_bounds", f"random {r}x{n}",
                      (randint(0, 8, r, n), rnd(r, n) * 100,
                       rnd(r, n) * 200), kw))
    r, n = 4, 50
    cases.append(("fused_event_bounds", "empty sets (+inf)",
                  (torch.full((r, n), 7, dtype=torch.int32, device=dev),
                   rnd(r, n), rnd(r, n)), kw))
    zs = torch.zeros((r, n), device=dev)
    zs[:, 1::3] = -0.0
    cases.append(("fused_event_bounds", "-0.0/+0.0 and +inf",
                  (randint(0, 4, r, n), zs,
                   torch.full((r, n), float("inf"), device=dev)), kw))
    return cases


def check_kernels(K, KREF, dev) -> dict:
    errs = {name: 0.0 for name in K.NAMES}
    for name, label, args, kw in kernel_cases(dev):
        got = getattr(K, name)(*args, **kw)
        again = getattr(K, name)(*args, **kw)
        torch.cuda.synchronize()
        want = getattr(KREF, name + "_ref")(*args, **kw)
        errs[name] = max(errs[name], compare(f"{name} {label}", got, want))
        compare(f"{name} {label}, second launch", again, got)
        log("3 kernels", f"{name} {label}: bitwise equal, twice")
    return errs


def fma_cases(dev):
    """(label, (x, w, acc)) cases of the multiply-add kernel: the forward
    pass's broadcast shapes at the learned path's width (R = 4096, M =
    32, H = 16), strided views, the queue C probe (a product below half
    an ulp of acc, which a float64 sum rounded twice gets wrong), signed
    zeros and subnormal results."""
    g = torch.Generator(device="cpu").manual_seed(3)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(dev)

    x = np.float32(2**-12 * (1 + 2**-18))
    w = np.float32(2**-12 * (1 - 2**-18))
    acc = np.float32(1 + 2**-23)
    feats = rnd(4096, 32, 9)
    hid = rnd(4096, 32, 16)
    return [
        ("chain (R, M, 1) x (H,) + (R, M, H)",
         (feats[..., 3, None], rnd(16), rnd(4096, 32, 16))),
        ("shared lanes (R, M, 4, 1) x (4, H) + (R, M, 4, H)",
         (feats[..., 4:8, None], rnd(4, 16), rnd(4096, 32, 4, 16))),
        ("batched lanes (R, M, 8) x (R, 1, 8) + (R, M, 8)",
         (hid[..., 8:16], rnd(4096, 1, 8), rnd(4096, 32, 8))),
        ("features (R,) x (R,) + (R,)", (rnd(4096), rnd(4096), rnd(4096))),
        ("queue C probe, broadcast to (R, M)",
         (torch.full((4096, 1), float(x), device=dev),
          torch.full((32,), float(w), device=dev),
          torch.full((4096, 32), float(acc), device=dev))),
        ("signed zeros",
         (torch.tensor([0.0, -0.0, 1.0, -1.0], device=dev),
          torch.tensor([1.0, 1.0, -0.0, 0.0], device=dev),
          torch.tensor([-0.0, -0.0, -0.0, 0.0], device=dev))),
        ("subnormal results", (rnd(8, 1000, scale=1e-20),
                               rnd(1000, scale=1e-19),
                               rnd(8, 1000, scale=1e-38))),
    ]


def check_fma(FMA, KREF, dev) -> float:
    """Each case on the card twice (bitwise equal), against the plain
    version on the card and on the CPU (the CPU twin), bitwise; then a
    call past the kernel's 32-bit indices, which must be refused."""
    from repro_torch.kernels import build
    err = 0.0
    for label, args in fma_cases(dev):
        got = FMA.fma(*args)
        again = FMA.fma(*args)
        torch.cuda.synchronize()
        compare(f"fma {label}, second launch", (again,), (got,))
        err = max(err, compare(f"fma {label}", (got,),
                               (KREF.fma_ref(*args),)))
        cpu = KREF.fma_ref(*(a.cpu() for a in args))
        compare(f"fma {label}, the CPU twin", (got.cpu(),), (cpu,))
        log("3 kernels", f"fma {label} {tuple(got.shape)}: bitwise equal to "
            f"the plain version on the card and on the CPU, twice")
    probe = FMA.fma(*fma_cases(dev)[4][1])
    if float(probe[0, 0]) != float(np.float32(1 + 2**-23)):
        raise AssertionError(f"fma: the probe gives {float(probe[0, 0])!r}")
    # past 2^31 elements the wrapper raises and the launcher refuses
    x, w = (torch.ones(s, device=dev) for s in ((2**16, 1), (1, 2**16)))
    before = FMA.launches["fma"]
    try:
        FMA.fma(x, w, x[0])
        raise AssertionError("fma: 2^32 elements were not refused")
    except ValueError:
        pass
    code = build.load("fma").e2c_fma(
        x.data_ptr(), w.data_ptr(), x.data_ptr(), x.data_ptr(),
        FMA.geometry(torch.Size([2**16, 2**16]), x, w, x[0]),
        torch.cuda.current_stream().cuda_stream)
    if code == 0 or FMA.launches["fma"] != before:
        raise AssertionError("fma: the launcher took 2^32 elements")
    log("3 kernels", "fma refuses 2^32 elements: the wrapper raises, the "
        f"launcher returns {build.load('fma').e2c_error_string(code)!r}")
    return err


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------
def fields(st):
    t, m = st.tasks, st.machines
    out = {"time": st.time, "n_events": st.n_events, "status": t.status,
           "machine": t.machine, "seq": t.seq, "t_start": t.t_start,
           "t_end": t.t_end, "running": m.running,
           "busy_until": m.busy_until, "active_time": m.active_time,
           "energy": m.energy, "mq_count": st.mq_count,
           "n_live": st.n_live, "n_preempts": st.n_preempts,
           "n_batch": st.n_batch, "seq_counter": st.seq_counter,
           "rr_ptr": st.rr_ptr}
    if st.deps_left is not None:
        out["deps_left"] = st.deps_left
    return out


def bitwise_equal(got: dict, want: dict, what: str) -> None:
    """Raise unless every field of ``got`` equals ``want`` bit for bit
    (compared on ``want``'s device)."""
    if got.keys() != want.keys():
        raise AssertionError(f"{what}: fields {sorted(got)} != "
                             f"{sorted(want)}")
    for key in want:
        a = got[key].to(want[key].device)
        if a.shape != want[key].shape or not torch.equal(bits(a),
                                                         bits(want[key])):
            raise AssertionError(f"{what}: {key} differs")


@contextlib.contextmanager
def capturing(K, at):
    """Within the block, each kernel wrapper of ``K`` clones its inputs
    at the calls numbered in ``at`` (1-based, per wrapper; ``None``: the
    first call of each distinct tuple of input shapes) into the yielded
    ``{name: [(call, args, kwargs), ...]}``."""
    captured = {name: [] for name in K.NAMES}
    originals = {name: getattr(K, name) for name in K.NAMES}

    def wrap(name, fn):
        count, seen = [0], set()

        def wrapped(*args, **kw):
            count[0] += 1
            key = None if at is not None else tuple(
                tuple(a.shape) for a in args if isinstance(a, torch.Tensor))
            if (count[0] in at) if at is not None else key not in seen:
                seen.add(key)
                captured[name].append((count[0], tuple(
                    a.clone() if isinstance(a, torch.Tensor) else a
                    for a in args), dict(kw)))
            return fn(*args, **kw)
        return wrapped

    for name, fn in originals.items():
        setattr(K, name, wrap(name, fn))
    try:
        yield captured
    finally:
        for name, fn in originals.items():
            setattr(K, name, fn)


@contextlib.contextmanager
def counting_syncs(targets: dict):
    """Within the block, each function of ``targets`` ({name: (owner,
    attribute)}) runs under ``torch.cuda.set_sync_debug_mode("warn")``;
    the yielded dict receives, per call of each, the number of operations
    that synchronised the host with the card.  A call's count leaves out
    those of the targets it calls (``run_stream``'s, those of its
    ``Plan.make``: its one-off set-up, the policies present and their
    rows)."""
    import warnings
    counts = {name: [] for name in targets}
    saved = {name: vars(owner)[attr]
             for name, (owner, attr) in targets.items()}

    def counted(name, fn):
        def wrapped(*args, **kw):
            prev = torch.cuda.get_sync_debug_mode()
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    out = fn(*args, **kw)
                finally:
                    torch.cuda.set_sync_debug_mode(prev)
            counts[name].append(sum("synchronizing" in str(w.message)
                                    for w in seen))
            return out
        return wrapped

    for name, (owner, attr) in targets.items():
        fn = counted(name, getattr(owner, attr))
        # a class's method stays callable on the class, already bound
        setattr(owner, attr, staticmethod(fn)
                if isinstance(owner, type) else fn)
    try:
        yield counts
    finally:
        for name, (owner, attr) in targets.items():
            setattr(owner, attr, saved[name])


def make_spec(X, E, path, n_rep, n_tasks, n_mach, seed=0, max_events=None,
              shapes=SHAPES, traced=None, window=STREAM_WINDOW,
              chunk=STREAM_CHUNK, scenario=None):
    """The spec of a sweep path (``PATHS``); ``shapes`` are the workflow
    path's DAG shapes; ``traced`` turns trace and metrics on (default:
    on the traced path only); ``window`` and ``chunk`` size the stream
    path's window, which runs the flat spec's draws (``scenario``: the
    scenario spec's)."""
    if scenario is None:
        scenario = {"scenario": X.ScenarioAxis(**SCENARIO),
                    "traced": X.ScenarioAxis(**SCENARIO),
                    "workflow": X.ScenarioAxis(**WORKFLOW_SCENARIO)
                    }.get(path)
    workload = X.WorkloadAxis(n_tasks, shapes=shapes
                              if path == "workflow" else None)
    if path == "stream":
        workload = X.WorkloadAxis(n_tasks, streaming=window,
                                  stream_chunk=chunk)
    drain_k = 8 if path == "flat_k8" else 1
    traced = path == "traced" if traced is None else traced
    learned = path == "learned"
    return X.ExperimentSpec(n_rep, X.FleetAxis(n_mach), workload,
                            scenario=scenario,
                            policy=X.PolicyAxis(LEARNED if learned
                                                else POLICIES),
                            sim=E.SimParams(max_events=max_events,
                                            drain_k=drain_k),
                            trace=traced, metrics=traced, learned=learned,
                            seed=seed)


def path_weights(path):
    """The learned path's shared weights, drawn on the host (a CPU
    generator, so the card and the CPU get the same numbers); None on the
    other paths."""
    if path != "learned":
        return None
    from repro_torch.core import neural as NN
    return NN.init_params(0, device="cpu")


def check_workflow(S, reps, st) -> tuple[int, int]:
    """On the card: no task started before the last end of its parents,
    and every task that ran had only completed parents.  Returns the
    number of cascade cancels (tasks cancelled with a failed parent) and
    of tasks that waited on a parent."""
    parents = reps.parents
    idx, valid = S.dep_index(parents)
    t_end_p = st.tasks.t_end.gather(1, idx).view(parents.shape)
    done_p = st.tasks.status.gather(1, idx).view(parents.shape) \
        == S.COMPLETED
    last = torch.where(valid, t_end_p, -float("inf")).amax(2)
    ran = st.tasks.t_start >= 0
    early = ran & ((st.tasks.t_start < last) | (valid & ~done_p).any(2))
    if bool(early.any()):
        bad = early.nonzero()[:5].tolist()
        raise AssertionError(f"workflow: tasks started before a parent "
                             f"completed at (replica, task) {bad}")
    _, failed = S.dep_state(st.tasks.status, parents, (idx, valid))
    cascade = int(((st.tasks.status == S.CANCELLED) & failed).sum())
    waited = int((ran & valid.any(2)).sum())
    return cascade, waited


def run_main(X, E, K, S, ST, P, dev, path, n_rep, n_tasks, n_mach):
    """Drive one main path through ``run_experiment``, the launch counts
    (the scheduling kernels' and the multiply-add's) set to 0 just before
    and read just after; returns the result, the launches, the inputs
    captured from the run, the loop counters, the execute seconds and the
    path's own peak device memory in GiB."""
    from repro_torch.kernels import fma as FMA
    phase = f"4 {path}"
    spec = make_spec(X, E, path, n_rep, n_tasks, n_mach)
    held = torch.cuda.memory_allocated() / 2**30
    t0 = time.perf_counter()
    reps = X.normalize(spec, device=dev)
    torch.cuda.synchronize()
    log(phase, f"normalize {n_rep} replicas x {n_tasks} tasks x "
        f"{n_mach} machines on the host: {time.perf_counter() - t0:.2f} s")
    stats = E.RunStats()
    torch.cuda.reset_peak_memory_stats()
    with capturing(K, CAPTURE_AT) as captured, \
            capturing(FMA, None) as fma_captured, \
            counting_syncs({"run_stream": (ST, "run_stream"),
                            "Plan.make": (P.Plan, "make")}) as syncs:
        K.reset_launches()
        FMA.reset_launches()
        t0 = time.perf_counter()
        res = X.run_experiment(spec, device=dev, replicas=reps, stats=stats,
                               policy_params=path_weights(path))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {**K.launches, **FMA.launches}
    captured.update(fma_captured)
    for row in res.by_policy(("completion_rate", "missed", "cancelled",
                              "preempted", "requeues", "availability",
                              "energy", "makespan", "mean_response")):
        log(phase, json.dumps(row))
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(phase, f"execute {wall:.3f} s (synchronised); event steps "
        f"{stats.events}, drain trips {stats.drain_trips}, release trips "
        f"{stats.release_trips}, host reads {stats.host_reads}; peak "
        f"device memory {peak:.2f} GiB, the path's own {peak - held:.2f} "
        f"GiB (its normalized inputs counted) above the {held:.2f} GiB "
        f"held before it (earlier paths' captured kernel inputs); "
        f"{gpu_line()}")
    peak -= held
    if path == "scenario":
        log(phase, f"preempted {int(res.metrics['preempted'].sum())} tasks,"
            f" requeued {int(res.metrics['requeues'].sum())} evictions; "
            f"mean availability "
            f"{float(res.metrics['availability'].mean()):.4f}")
    log(phase, f"kernel launches {json.dumps(launches)}")
    for name in PATH_KERNELS.get(path, K.NAMES) \
            + (FMA.NAMES if path in FMA_PATHS else ()):
        if launches[name] <= 0:
            raise AssertionError(f"{name} never launched on the {path} path")
    if path == "stream":
        check_stream(E, res, stats, n_tasks, syncs)
    elif not bool((res.state.tasks.status >= S.COMPLETED).all()):
        raise AssertionError(f"live tasks left at the end of the {path} "
                             "path")
    for key, col in res.metrics.items():
        if col.shape != (n_rep,) or not bool(torch.isfinite(
                col.float()).all()):
            raise AssertionError(f"summary column {key} is not finite "
                                 f"(R,): {tuple(col.shape)}")
    for key in ("completion_rate", "availability"):
        col = res.metrics[key]
        if not bool(((col >= 0) & (col <= 1)).all()):
            raise AssertionError(f"{key} outside [0, 1]")
    st = res.state
    if path in ("scenario", "traced") and not int(st.n_preempts.sum()):
        raise AssertionError("the scenario path evicted no task")
    if path == "workflow":
        cascade, waited = check_workflow(S, reps, st)
        log(phase, f"precedence held for {waited} tasks that waited on a "
            f"parent; {cascade} cascade cancels; parent tables "
            f"{tuple(reps.parents.shape)}; preempted "
            f"{int(res.metrics['preempted'].sum())}, requeued "
            f"{int(res.metrics['requeues'].sum())}")
        if not cascade:
            raise AssertionError("the workflow path cancelled no task "
                                 "for a failed parent")
    log(phase, f"all {n_rep * n_tasks} tasks terminal; summaries finite")
    return res, launches, captured, stats, wall, peak


def check_stream(E, res, stats, n_tasks, syncs) -> None:
    """The stream path's invariants, on the card: every replica retired
    every task (none stalled) and holds no live task, the outcome counts
    sum to the retired, every host read was a drain's, and the window
    engine synchronised with the host at those reads only (``syncs``, of
    :func:`counting_syncs`)."""
    ws, spec = res.window, res.spec
    a = ws.agg
    if not bool((a.retired == n_tasks).all()):
        raise AssertionError(f"stream: {int((a.retired < n_tasks).sum())} "
                             "replicas stalled")
    if bool((ws.sim.n_live != 0).any()):
        raise AssertionError("stream: live tasks left in a window")
    total = a.completed + a.cancelled + a.missed_queue + a.missed_running \
        + a.preempted
    if not bool((total == a.retired).all()):
        raise AssertionError("stream: outcome counts do not sum to the "
                             "retired tasks")
    drain_reads = stats.drain_trips // E.DRAIN_CHUNK
    if stats.host_reads != drain_reads:
        raise AssertionError(f"stream: {stats.host_reads} host reads, "
                             f"{drain_reads} drain chunks")
    if syncs["run_stream"] != [stats.host_reads]:
        raise AssertionError(f"stream: run_stream synchronised "
                             f"{syncs['run_stream']} times, "
                             f"{stats.host_reads} host reads counted")
    n_chunks = -(-n_tasks // spec.stream_chunk)
    most = int(ws.sim.n_events.max())
    log("4 stream", f"window {tuple(ws.slot_task.shape)} (W = "
        f"{spec.workload.streaming}, {n_chunks} chunks of "
        f"{spec.stream_chunk}); every replica retired {n_tasks} tasks, "
        f"none stalled, none live; event steps {stats.events} (most events "
        f"of a replica {most}; 2 N + chunks = {2 * n_tasks + n_chunks}), "
        f"host reads {stats.host_reads}, one a drain chunk, and as many "
        f"synchronising operations in run_stream ({syncs['run_stream'][0]}"
        f", besides the {syncs['Plan.make'][0]} of its set-up, Plan.make); "
        f"{gpu_line()}")


def agg_equal(got, want, what: str) -> None:
    """Raise unless two ``SweepAgg``s are bitwise equal in every field."""
    if got.columns != want.columns or got.policies != want.policies \
            or not np.array_equal(got.counts, want.counts):
        raise AssertionError(f"{what}: columns, policies or counts differ")
    for k in want.columns:
        for part in ("a", "b", "hist", "vmin", "vmax"):
            x, y = getattr(got, part)[k], getattr(want, part)[k]
            if x.dtype != y.dtype or x.tobytes() != y.tobytes():
                raise AssertionError(f"{what}: {k} {part} differs")


def run_chunked(X, E, K, P, dev, n_rep, chunk, n_tasks, n_mach, flat):
    """Drive the chunked path: the flat spec at ``n_rep`` replicas through
    ``run_experiment(chunk=..., keep_replicas=True)`` with telemetry on,
    the launch counts set to 0 just before and read just after and the
    host-synchronising operations counted.  ``flat`` is the flat path's
    (host summary columns, execute seconds, own peak GiB) or None.
    Returns what :func:`run_main` returns."""
    from repro_torch.core import telemetry as TL
    from repro_torch.launch import chunked as CH
    phase = "4 chunked"
    spec = make_spec(X, E, "chunked", n_rep, n_tasks, n_mach)
    held = torch.cuda.memory_allocated() / 2**30
    stats = E.RunStats()
    torch.cuda.reset_peak_memory_stats()
    tlog = TL.enable(os.path.join(ROOT, "build", "telemetry"))
    try:
        with capturing(K, CAPTURE_AT) as captured, counting_syncs({
                "run_experiment": (X, "run_experiment"),
                "run_sweep": (E, "run_sweep"),
                "Plan.make": (P.Plan, "make")}) as syncs:
            K.reset_launches()
            t0 = time.perf_counter()
            res = X.run_experiment(spec, device=dev, chunk=chunk,
                                   keep_replicas=True, stats=stats)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(K.launches)
    finally:
        TL.disable()
    peak = torch.cuda.max_memory_allocated() / 2**30 - held
    cs, agg = res.chunked, res.agg
    log(phase, f"{n_rep} replicas x {n_tasks} tasks x {n_mach} machines in "
        f"{cs.n_chunks} chunks of {chunk}: execute {wall:.3f} s "
        f"(synchronised); ChunkedStats normalize_s {cs.normalize_s:.3f}, "
        f"dispatch_s {cs.dispatch_s:.3f}, sync_s {cs.sync_s:.3f}, "
        f"overlap_s {cs.overlap_s:.3f}, overlap_frac "
        f"{cs.overlap_frac:.4f}, wall_s {cs.wall_s:.3f}; event steps "
        f"{stats.events}, drain trips {stats.drain_trips}, host reads "
        f"{stats.host_reads}; {gpu_line()}")
    spans = {(r["name"], r.get("chunk")): r for r in
             TL.read_jsonl(tlog.path) if r["kind"] == "span"}
    flat_wall = flat[1] if flat is not None else float("nan")
    for c in range(cs.n_chunks):
        norm = spans[("chunk_normalize", c)]
        size = min(chunk, n_rep - c * chunk)
        where = ("beside the previous chunk" if norm["overlapped"]
                 else "before the first chunk")
        log(phase, f"chunk {c} ({size} replicas): normalize "
            f"{norm['dur_s']:.3f} s ({where}), "
            f"dispatch {spans[('chunk_dispatch', c)]['dur_s']:.3f} s, sync "
            f"{spans[('chunk_sync', c)]['dur_s']:.3f} s; the flat path's "
            f"monolithic execute {flat_wall:.3f} s")
    log(phase, f"kernel launches {json.dumps(launches)}")
    for name in K.NAMES:
        if launches[name] <= 0:
            raise AssertionError(f"{name} never launched on the chunked "
                                 "path")
    outside = syncs["run_experiment"][0]
    engine, setup = sum(syncs["run_sweep"]), sum(syncs["Plan.make"])
    log(phase, f"host-synchronising operations: {engine} in the engine "
        f"({stats.host_reads} host reads), {setup} in Plan.make's set-up "
        f"of the {cs.n_chunks} chunks, {outside} in the chunk loop (allowed: "
        f"one a chunk at retirement and the aggregate's read, "
        f"{cs.n_chunks + 1})")
    if engine != stats.host_reads or outside > cs.n_chunks + 1:
        raise AssertionError("chunked: the chunk loop synchronised where it "
                             "may not")
    kept = res.metrics
    for key, col in kept.items():
        if col.shape != (n_rep,) or not bool(torch.isfinite(
                col.float()).all()):
            raise AssertionError(f"chunked: kept column {key} is not "
                                 f"finite (R,): {tuple(col.shape)}")
    n_p = len(POLICIES)
    if agg.count() != n_rep or any(
            agg.count(pol) != len(range(i, n_rep, n_p))
            for i, pol in enumerate(POLICIES)):
        raise AssertionError(f"chunked: counts {agg.counts.tolist()}")
    pids = torch.tensor([P.POLICY_IDS[POLICIES[r % n_p]]
                         for r in range(n_rep)], dtype=torch.int32)
    agg_equal(CH.aggregate_metrics({k: v.to(dev) for k, v in kept.items()},
                                   pids, POLICIES), agg,
              "chunked: one fold of the kept columns != the run's")
    what = "flat path not run in this call"
    if flat is not None:
        rows = min(len(next(iter(flat[0].values()))), n_rep)
        bitwise_equal({k: v[:rows] for k, v in kept.items()},
                      {k: v[:rows] for k, v in flat[0].items()},
                      "chunked: kept rows != the flat path's")
        what = (f"rows 0-{rows - 1} bitwise the flat path's; own peak "
                f"{peak:.2f} GiB against the flat path's {flat[2]:.2f} GiB "
                f"({peak / flat[2]:.3f}x)")
        if peak > 1.25 * flat[2]:
            raise AssertionError("chunked: own peak above 1.25x the flat "
                                 "path's")
    log(phase, f"{agg.count()} replicas folded ({agg.count(POLICIES[0])} "
        f"a policy), one fold of the kept columns on the card bitwise the "
        f"run's SweepAgg; kept {what}; own peak {peak:.2f} GiB (its "
        f"normalized inputs counted) above the {held:.2f} GiB held before "
        f"it; makespan mean {agg.mean('makespan'):.4f}, p99 "
        f"{agg.quantile('makespan', 99.0):.4f}; {gpu_line()}")
    return res, launches, captured, stats, wall, peak


def recheck_captured(K, KREF, captured, path) -> None:
    from repro_torch.kernels import fma as FMA
    for name in K.NAMES:
        for call, args, kw in captured[name]:
            got = getattr(K, name)(*args, **kw)
            want = getattr(KREF, name + "_ref")(*args, **kw)
            compare(f"{name} {path} call {call}", got, want)
            log("3 kernels", f"{name} captured at {path}-path call {call}: "
                "bitwise equal")
    for call, args, _ in captured.get("fma", ()):
        got = FMA.fma(*args)
        compare(f"fma {path} call {call}", (got.cpu(),),
                (KREF.fma_ref(*(a.cpu() for a in args)),))
        log("3 kernels", f"fma captured at {path}-path call {call} "
            f"{tuple(got.shape)}: bitwise equal to the CPU twin")


def trace_fields(st) -> dict:
    """The trace's valid rows (the spare column cut), ``n_rows``, the
    snapshots and the metrics counts of a traced state."""
    tb, mt = st.trace, st.metrics
    cap = tb.cap
    pos = torch.arange(cap, device=tb.n_rows.device)
    valid = pos[None, :] < tb.n_rows[:, None]
    out = {f: torch.where(valid, getattr(tb, f)[:, :cap], 0) for f in
           ("ev_time", "ev_kind", "ev_task", "ev_machine")}
    out.update({f: getattr(tb, f) for f in
                ("n_rows", "snap_time", "snap_batch", "snap_mq",
                 "snap_running", "snap_energy")})
    out.update({f: getattr(mt, f) for f in mt._FIELDS})
    return out


def card_vs_cpu(X, E, dev, path, traced=None) -> None:
    spec = make_spec(X, E, path, 64, 128, 8, seed=1, shapes=ALL_SHAPES,
                     traced=traced)
    on_card = X.run_experiment(spec, device=dev)
    on_cpu = X.run_experiment(spec, device="cpu")
    bitwise_equal(fields(on_card.state), fields(on_cpu.state),
                  f"{path}: card != CPU")
    bitwise_equal(on_card.metrics, on_cpu.metrics,
                  f"{path}: card != CPU in the summary")
    what = f"{path} sweep" + (f" ({', '.join(ALL_SHAPES)})"
                              if path == "workflow" else "")
    extra = ""
    if spec.trace:
        bitwise_equal(trace_fields(on_card.state),
                      trace_fields(on_cpu.state),
                      f"{path}: card != CPU in the trace or the counts")
        rows = int(on_card.state.trace.n_rows.sum())
        extra = (f", traced with metrics: {rows} trace rows, the "
                 "snapshots, histogram and window counts and tail columns")
    log("5 card=cpu", f"64x128x8 {what}: every state field and summary "
        f"column{extra} bitwise equal to the CPU run")


def window_fields(ws) -> dict:
    """Every tensor of a final streaming window by dotted name, the trace
    rows cut to the valid ones (the spare column takes dropped writes in
    any order)."""
    out = {}

    def walk(obj, prefix):
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if isinstance(v, torch.Tensor):
                out[prefix + f.name] = v
            elif dataclasses.is_dataclass(v):
                walk(v, f"{prefix}{f.name}.")
    walk(ws, "")
    tb = ws.sim.trace
    if tb is not None:
        pos = torch.arange(tb.cap, device=tb.n_rows.device)
        valid = pos[None, :] < tb.n_rows[:, None]
        for f in ("ev_time", "ev_kind", "ev_task", "ev_machine"):
            out[f"sim.trace.{f}"] = torch.where(valid,
                                                getattr(tb, f)[:, :tb.cap], 0)
    return out


def stream_card_vs_cpu(X, E, dev) -> None:
    """The stream path's card-vs-CPU cases at 64 x 128 x 8: the flat
    spec at W = 32 and W = 128 = N (whose window is also the dense flat
    run's final state on the card), the scenario spec at W = 32, a chain
    and a fork-join workflow through ``simulate_stream``, and the W = 32
    flat spec traced with metrics."""
    from repro_torch.core import streaming as ST
    from repro_torch.core import workload as W
    from repro_torch.core.eet import synth_eet
    phase = "5 card=cpu"
    cases = [("flat W=32", dict(window=32, chunk=16)),
             ("flat W=128", dict(window=128, chunk=32)),
             ("scenario W=32", dict(window=32, chunk=16,
                                    scenario=X.ScenarioAxis(**SCENARIO))),
             ("flat W=32 traced", dict(window=32, chunk=16, traced=True))]
    for what, kw in cases:
        spec = make_spec(X, E, "stream", 64, 128, 8, seed=1, **kw)
        on_card = X.run_experiment(spec, device=dev)
        on_cpu = X.run_experiment(spec, device="cpu")
        bitwise_equal(window_fields(on_card.window),
                      window_fields(on_cpu.window),
                      f"stream {what}: card != CPU")
        bitwise_equal(on_card.metrics, on_cpu.metrics,
                      f"stream {what}: card != CPU in the summary")
        if not bool((on_cpu.window.agg.retired == 128).all()):
            raise AssertionError(f"stream {what}: a replica stalled")
        extra = ""
        if kw["window"] == 128:
            dense = X.run_experiment(make_spec(X, E, "flat", 64, 128, 8,
                                               seed=1), device=dev).state
            ws = on_card.window
            if not torch.equal(ws.slot_task[0].cpu(), torch.arange(
                    128, dtype=torch.int32)):
                raise AssertionError("stream W=N: slots not in id order")
            bitwise_equal({k: v for k, v in fields(ws.sim).items()
                           if k != "deps_left"},
                          fields(dense), "stream W=N != the dense run")
            extra = "; the window bitwise the dense flat run's final state"
        if spec.trace:
            extra = (f"; {int(on_card.window.sim.trace.n_rows.sum())} trace"
                     " rows, snapshots, counts and tail columns")
        log(phase, f"64x128x8 streaming {what}: every window field and "
            f"summary column bitwise equal to the CPU run{extra}")
    eet = synth_eet(4, 4, inconsistency=0.3, seed=5)
    me = eet.eet.mean(1)
    power = np.array([[20, 100], [30, 150], [40, 200], [25, 120]],
                     np.float32)
    mtype = np.arange(8) % 4
    for wf in (W.chain_workflow(128, 4, mean_eet=me, slack_jitter=0.4,
                                seed=2),
               W.fork_join_workflow(16, 6, 4, mean_eet=me, slack_jitter=0.4,
                                    seed=2)):
        window = max(32, ST.min_window(wf.parents) + 15)
        runs = [ST.simulate_stream(wf, eet, power, mtype, "heft",
                                   window=window, chunk=16, trace=True,
                                   device=d) for d in (dev, "cpu")]
        bitwise_equal(window_fields(runs[0].ws), window_fields(runs[1].ws),
                      f"stream workflow N={wf.n_tasks}: card != CPU")
        if runs[1].stalled or runs[0].summarize() != runs[1].summarize():
            raise AssertionError(f"stream workflow N={wf.n_tasks}: stalled "
                                 "or the report rows differ")
        log(phase, f"simulate_stream of a {wf.n_tasks}-task workflow (in-"
            f"degree up to {ST.min_window(wf.parents) - 1}) through W = "
            f"{window}, heft, traced: every window field, trace row and "
            "the report row bitwise equal to the CPU run")


def chunked_card_vs_cpu(X, E, dev) -> None:
    """The chunked path's card-vs-CPU cases: the flat, scenario, workflow
    (all four shapes; a chunk of 24 splits a cell of the ten paired
    policies, and every chunk pads to the grid's widest in-degree) and
    streaming (W = 32) specs at 64 x 128 x 8 in chunks of 24, and
    docs/scaling.md's cell of 3000 replicas in chunks of 1000; the CPU
    runs each spec whole and folds it with ``aggregate_metrics``."""
    from repro_torch.launch import chunked as CH
    phase = "5 card=cpu"
    cases = [
        ("flat", make_spec(X, E, "flat", 64, 128, 8, seed=1), 24),
        ("scenario", make_spec(X, E, "scenario", 64, 128, 8, seed=1), 24),
        ("workflow", make_spec(X, E, "workflow", 64, 128, 8, seed=1,
                               shapes=ALL_SHAPES), 24),
        ("streaming W=32", make_spec(X, E, "stream", 64, 128, 8, seed=1,
                                     window=32, chunk=16), 24),
        ("docs/scaling.md cell", X.ExperimentSpec(
            3000, X.FleetAxis(4), X.WorkloadAxis(16),
            policy=X.PolicyAxis(("mct", "ee_mct"))), 1000)]
    for what, spec, chunk in cases:
        on_card = X.run_experiment(spec, device=dev, chunk=chunk,
                                   keep_replicas=True)
        # the CPU side folds its monolithic run's columns at once: the
        # aggregate does not depend on the chunking, and the kept columns
        # are held against the same run
        on_cpu = X.run_experiment(spec, device="cpu")
        agg_equal(on_card.agg, CH.aggregate_metrics(
            on_cpu.metrics, on_cpu.replicas.policy_ids,
            spec.policy.policies), f"chunked {what}: card != CPU")
        bitwise_equal(on_card.metrics, on_cpu.metrics,
                      f"chunked {what}: kept columns != the CPU run's")
        extra = ""
        if spec.workflow:
            extra = (f"; parent tables padded to the grid's K = "
                     f"{X._workflow_kmax(spec)}")
        log(phase, f"chunked {what}, {spec.n_replicas} replicas in chunks "
            f"of {chunk}: every SweepAgg field and kept column bitwise "
            f"equal to the CPU run's{extra}")


def smoke_mct(state, view):
    """A user policy: minimum expected completion for the head task (a
    re-implementation of ``mct``)."""
    scores = torch.where((view.head >= 0)[:, None],
                         view.completion_row(view.head), 1e30)
    return view.head, scores, view.room


def user_policy_on_card(X, E, K, P, dev) -> None:
    """A registered policy on the card: alone, its machine pick is one
    ``masked_argmin`` launch a drain trip; in a mixed-id sweep beside
    built-ins the run is bitwise the CPU run."""
    if "smoke_mct" not in P.POLICY_IDS:
        P.register_policy("smoke_mct", smoke_mct)
    phase = "5 user policy"

    def spec(policies):
        return X.ExperimentSpec(64, X.FleetAxis(8), X.WorkloadAxis(128),
                                policy=X.PolicyAxis(policies), seed=3)
    saved = dict(K.launches)
    K.reset_launches()
    stats = E.RunStats()
    X.run_experiment(spec(("smoke_mct",)), device=dev, stats=stats)
    torch.cuda.synchronize()
    launches = dict(K.launches)
    K.launches.update(saved)
    if launches["masked_argmin"] != stats.drain_trips or \
            not stats.drain_trips:
        raise AssertionError(f"user policy: {launches['masked_argmin']} "
                             f"masked_argmin launches for "
                             f"{stats.drain_trips} drain trips")
    mixed = spec(("mct", "smoke_mct", "minmin", "fcfs", "rr"))
    on_card = X.run_experiment(mixed, device=dev)
    on_cpu = X.run_experiment(mixed, device="cpu")
    bitwise_equal(fields(on_card.state), fields(on_cpu.state),
                  "user policy: card != CPU")
    log(phase, f"smoke_mct registered as id {P.POLICY_IDS['smoke_mct']}: "
        f"alone {launches['masked_argmin']} masked_argmin launches for "
        f"{stats.drain_trips} drain trips; mixed with mct, minmin, fcfs "
        f"and rr at 64x128x8, every state field bitwise equal to the CPU "
        f"run")


def learned_card_vs_cpu(X, E, dev) -> None:
    """The learned path's card-vs-CPU cases at 64 x 128 x 8 with random
    weights drawn on the host: the flat spec at K = 1 and K = 8, the
    scenario spec, the streaming spec (W = 32) and a chunked run (chunks
    of 24); and the warm starts on the card: ``mlp`` with
    ``ee_mlp_params`` bitwise ``ee_mct``, with ``mct_mlp_params``
    bitwise ``mct``."""
    from repro_torch.core import neural as NN
    from repro_torch.launch import chunked as CH
    phase = "5 card=cpu"
    pp = NN.init_params(5, device="cpu")

    def spec(path="learned", **kw):
        return make_spec(X, E, path, 64, 128, 8, seed=1, **kw)

    learned = X.PolicyAxis(LEARNED)
    cases = [("flat", spec()),
             ("flat K=8", spec().with_(sim=E.SimParams(drain_k=8))),
             ("scenario", spec(scenario=X.ScenarioAxis(**SCENARIO))),
             ("streaming W=32", spec("stream", window=32, chunk=16).with_(
                 policy=learned, learned=True))]
    flat_cpu = None
    for what, sp in cases:
        on_card = X.run_experiment(sp, device=dev, policy_params=pp)
        # the K = 8 run against the CPU's K = 1 run (the port's K-way
        # drain is bitwise its one-decision drain, tests/test_torch_neural)
        on_cpu = flat_cpu if what == "flat K=8" else X.run_experiment(
            sp, device="cpu", policy_params=pp)
        if what == "flat":
            flat_cpu = on_cpu
        if sp.streaming:
            bitwise_equal(window_fields(on_card.window),
                          window_fields(on_cpu.window),
                          f"learned {what}: card != CPU")
        else:
            bitwise_equal(fields(on_card.state), fields(on_cpu.state),
                          f"learned {what}: card != CPU")
        bitwise_equal(on_card.metrics, on_cpu.metrics,
                      f"learned {what}: card != CPU in the summary")
        extra = "; against the CPU's K = 1 run" if what == "flat K=8" \
            else ""
        log(phase, f"64x128x8 learned {what} (mlp, linear, random "
            f"weights): every state field and summary column bitwise equal "
            f"to the CPU run{extra}")
    # the chunked run against the CPU's fold of the flat case's run
    sp = spec()
    on_card = X.run_experiment(sp, device=dev, chunk=24, keep_replicas=True,
                               policy_params=pp)
    agg_equal(on_card.agg, CH.aggregate_metrics(
        flat_cpu.metrics, flat_cpu.replicas.policy_ids, sp.policy.policies),
        "learned chunked: card != CPU")
    bitwise_equal(on_card.metrics, flat_cpu.metrics,
                  "learned chunked: kept columns != the CPU run's")
    log(phase, "learned chunked, 64 replicas in chunks of 24: every "
        "SweepAgg field and kept column bitwise equal to the CPU run's")
    base = make_spec(X, E, "flat", 64, 128, 8, seed=1)
    for heuristic, warm in (("ee_mct", NN.ee_mlp_params("cpu")),
                            ("mct", NN.mct_mlp_params("cpu"))):
        want = X.run_experiment(base.with_(policy=X.PolicyAxis(
            (heuristic,))), device=dev)
        got = X.run_experiment(base.with_(policy=X.PolicyAxis(("mlp",))),
                               device=dev, policy_params=warm)
        bitwise_equal(fields(got.state), fields(want.state),
                      f"mlp warm start != {heuristic} on the card")
        log(phase, f"mlp with the {heuristic} warm start on the card: every "
            f"state field bitwise equal to {heuristic}'s run")


def run_es(E, K, dev, generations: int):
    """The es path: ``learn.train_and_evaluate`` at the documented full
    configuration with ``generations`` generations, the launch counts set
    to 0 just before and read just after; every ``run_sweep`` call
    counted and timed.  Returns the launches, the captured kernel inputs,
    the execute seconds and the path's own peak device memory in GiB."""
    from repro_torch.core import train_policy as TP
    from repro_torch.kernels import fma as FMA
    from repro_torch.launch import learn as L
    phase = "4 es"
    cfg = TP.ESConfig(pop=ES_POP, generations=generations)
    gen_rows = (2 * ES_POP + 1) * ES_GRID["n_train"]
    calls = []
    real = E.run_sweep

    def timed(tasks, *args, **kw):
        t0 = time.perf_counter()
        out = real(tasks, *args, **kw)
        torch.cuda.synchronize()
        calls.append((tasks.arrival.shape[0], time.perf_counter() - t0))
        return out

    out_dir = os.path.join(ROOT, "build", "learned")
    held = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    E.run_sweep = timed
    try:
        with capturing(K, CAPTURE_AT) as captured, \
                capturing(FMA, None) as fma_captured:
            K.reset_launches()
            FMA.reset_launches()
            t0 = time.perf_counter()
            payload = L.train_and_evaluate(cfg=cfg, out_dir=out_dir,
                                           device=dev, **ES_GRID)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {**K.launches, **FMA.launches}
        captured.update(fma_captured)
    finally:
        E.run_sweep = real
    peak = torch.cuda.max_memory_allocated() / 2**30 - held
    gens = [sec for rows, sec in calls if rows == gen_rows]
    others = [(rows, round(sec, 3)) for rows, sec in calls
              if rows != gen_rows]
    log(phase, f"train_and_evaluate {ES_GRID}, pop {ES_POP}, {generations} "
        f"generations (the documented 30 cut): {wall:.3f} s; run_sweep "
        f"calls {len(calls)}: {len(gens)} of {gen_rows} replicas (one a "
        f"generation), others (replicas, s) {others}; seconds a generation "
        f"{[round(g, 3) for g in gens]} (mean {np.mean(gens):.3f}); own peak "
        f"device memory {peak:.2f} GiB; {gpu_line()}")
    if len(gens) != generations or len(calls) != generations + 2:
        raise AssertionError(f"es: {len(calls)} run_sweep calls for "
                             f"{generations} generations")
    for h in payload["history"]["mlp"]:
        log(phase, json.dumps(h))
    for row in payload["rows"]:
        log(phase, json.dumps(row))
    names = [r["policy"] for r in payload["rows"]]
    if len(names) != 10 or names.count("mlp*") != 1:
        raise AssertionError(f"es: scoreboard rows {names}")
    svg = os.path.join(out_dir, "scoreboard.svg")
    if not open(svg).read().startswith("<svg"):
        raise AssertionError("es: no scoreboard SVG")
    for r in payload["rows"]:
        if not all(np.isfinite(r[k]) for k in r if k != "policy"):
            raise AssertionError(f"es: a scoreboard row is not finite: {r}")
    log(phase, f"kernel launches {json.dumps(launches)}; scoreboard and "
        f"its SVG written to {os.path.relpath(out_dir, ROOT)}/")
    for name in PATH_KERNELS.get("es", K.NAMES) + FMA.NAMES:
        if launches[name] <= 0:
            raise AssertionError(f"{name} never launched on the es path")
    return launches, captured, wall, peak


def es_card_vs_cpu(dev) -> None:
    """One ES generation at pop 3 on a 4-scenario grid (64 tasks x 8
    machines), the same host noise on the card and the CPU: ``e_scale``,
    the fitness values, theta', the gradient norm and the best theta
    bitwise equal."""
    from repro_torch.core import engine as E
    from repro_torch.core import neural as NN
    from repro_torch.core import train_policy as TP
    from repro_torch.launch import experiment as X
    from repro_torch.launch import learn as L
    spec = L.grid_spec(4, ES_GRID["n_tasks"], ES_GRID["n_machines"], seed=0)
    cfg = TP.ESConfig(pop=3, generations=1)
    eps = torch.randn((cfg.pop, NN.n_trainable("mlp")),
                      generator=torch.Generator().manual_seed(0))
    out = []
    for d in (dev, torch.device("cpu")):
        _, fitness_pop, e_scale = TP.make_fitness(
            X.normalize(spec, device=d), E.SimParams(), "mlp")
        init = NN.ee_mlp_params(d)
        theta, unravel = TP.ravel(init.mlp)
        step = TP.make_es_step(fitness_pop, unravel, init, "mlp", cfg)
        out.append((e_scale, step(theta, eps.to(d))))
    (e_card, got), (e_cpu, want) = out
    if e_card != e_cpu:
        raise AssertionError(f"es: e_scale {e_card} != {e_cpu}")
    bitwise_equal(dict(zip(("theta", "f_all", "grad_norm", "gen_best"), got)),
                  dict(zip(("theta", "f_all", "grad_norm", "gen_best"),
                           want)), "es generation: card != CPU")
    log("5 card=cpu", f"one ES generation, pop 3, 4 scenarios x 64 tasks x 8 "
        f"machines: e_scale, f_all {want[1].tolist()}, theta', grad norm "
        f"and best theta bitwise equal to the CPU's")


def check_k8(X, E, dev, res, stats, wall, flat_run, n_tasks, n_mach
             ) -> None:
    """The flat path at K = 8 against the flat path at K = 1 on the card:
    the final states bitwise equal.  ``flat_run`` is the K = 1 run's
    (fields, stats, execute seconds) at the same width, or None to run
    it here."""
    n_rep = res.replicas.n_replicas
    if flat_run is None:
        stats1 = E.RunStats()
        spec = make_spec(X, E, "flat", n_rep, n_tasks, n_mach)
        t0 = time.perf_counter()
        ref = X.run_experiment(spec, device=dev, replicas=res.replicas,
                               stats=stats1)
        torch.cuda.synchronize()
        flat_run = (fields(ref.state), stats1, time.perf_counter() - t0)
        del ref
    want, stats1, wall1 = flat_run
    bitwise_equal(fields(res.state), want, "flat_k8 != flat")
    log("4 flat_k8", f"final state bitwise equal to the K = 1 flat run's "
        f"at {n_rep} replicas; drain trips {stats.drain_trips} (K = 1: "
        f"{stats1.drain_trips}), host reads {stats.host_reads} "
        f"({stats1.host_reads}), execute {wall:.3f} s "
        f"({wall1:.3f} s)")


def check_trace_on_card(S, T, st, n_tasks) -> int:
    """The traced run's invariants, on the card: no overflow, N terminal
    rows a replica, every start row followed (in its task's rows) by a
    row that closes the segment, the response histogram and the
    completion windows summing to the completed count, the miss windows
    to the missed count and the queue-depth samples to the event count.
    Returns the trace rows."""
    tb, mt = st.trace, st.metrics
    if bool((tb.n_rows > tb.cap).any()):
        raise AssertionError("traced: a trace overflowed its capacity")
    cap = tb.cap
    pos = torch.arange(cap + 1, device=tb.n_rows.device)
    valid = pos[None, :] < tb.n_rows[:, None]
    kind = torch.where(valid, tb.ev_kind, -1)
    terminal = torch.tensor([T.EV_COMPLETE, T.EV_PREEMPT, T.EV_MISS_QUEUE,
                             T.EV_MISS_RUNNING, T.EV_CANCEL],
                            device=kind.device)
    n_term = torch.isin(kind, terminal).sum(1)
    if not bool((n_term == n_tasks).all()):
        raise AssertionError("traced: a replica's terminal rows are not N")
    # each task's rows in emission order: sort by (task, position)
    key = torch.where(valid, tb.ev_task.long() * (cap + 1) + pos,
                      torch.iinfo(torch.int64).max)
    order = torch.argsort(key, dim=1)
    k_s = kind.gather(1, order)
    t_s = tb.ev_task.gather(1, order)
    start = k_s == T.EV_START
    closers = torch.tensor(T.SEGMENT_CLOSERS, device=kind.device)
    closed = start[:, :-1] & (t_s[:, 1:] == t_s[:, :-1]) & torch.isin(
        k_s[:, 1:], closers)
    if not bool((closed.sum(1) == start.sum(1)).all()):
        raise AssertionError("traced: a start row is not closed")
    status = st.tasks.status
    done = (status == S.COMPLETED).sum(1, dtype=torch.int32)
    missed = ((status == S.MISSED_QUEUE) | (status == S.MISSED_RUNNING)
              ).sum(1, dtype=torch.int32)
    for name, got, want in (
            ("response", mt.response.sum(1), done),
            ("win_done", mt.win_done.sum(1), done),
            ("win_miss", mt.win_miss.sum(1), missed),
            ("queue_depth", mt.queue_depth.sum(1), st.n_events)):
        if not bool((got == want).all()):
            raise AssertionError(f"traced: the {name} counts do not sum "
                                 "to their population")
    return int(tb.n_rows.sum())


def check_traced(X, E, S, dev, res, stats, wall, plain_run, n_tasks,
                 n_mach) -> None:
    """The traced path against the untraced scenario run on the card
    (``plain_run``: its (fields, stats, execute seconds) at the same
    width, or None to run it here), the trace's invariants, and one
    replica's reports written under ``build/``."""
    from repro_torch.core import trace as T
    from repro_torch.core import viz
    n_rep = res.replicas.n_replicas
    if plain_run is None:
        stats1 = E.RunStats()
        spec = make_spec(X, E, "scenario", n_rep, n_tasks, n_mach)
        t0 = time.perf_counter()
        ref = X.run_experiment(spec, device=dev, replicas=res.replicas,
                               stats=stats1)
        torch.cuda.synchronize()
        plain_run = (fields(ref.state), stats1, time.perf_counter() - t0)
        del ref
    want, stats1, wall1 = plain_run
    bitwise_equal(fields(res.state), want, "traced != scenario")
    if stats.host_reads != stats1.host_reads or \
            stats.events != stats1.events:
        raise AssertionError(f"traced: host reads {stats.host_reads} / "
                             f"events {stats.events} against "
                             f"{stats1.host_reads} / {stats1.events}")
    st = res.state
    rows = check_trace_on_card(S, T, st, n_tasks)
    tb = st.trace
    snap_bytes = sum(getattr(tb, f).numel() * getattr(tb, f).element_size()
                     for f in ("snap_time", "snap_batch", "snap_mq",
                               "snap_running", "snap_energy"))
    row_bytes = sum(getattr(tb, f).numel() * getattr(tb, f).element_size()
                    for f in ("ev_time", "ev_kind", "ev_task",
                              "ev_machine"))
    log("4 traced", f"final state bitwise equal to the untraced scenario "
        f"run's at {n_rep} replicas; host reads {stats.host_reads} "
        f"({stats1.host_reads}), event steps {stats.events} "
        f"({stats1.events}); execute traced {wall:.3f} s, untraced "
        f"{wall1:.3f} s; {rows} trace rows ({rows / n_rep:.1f} a replica, "
        f"capacity {tb.cap}, none overflowed), buffers: rows "
        f"{row_bytes / 2**30:.2f} GiB, snapshots {snap_bytes / 2**30:.2f} "
        f"GiB (E = {tb.max_events}); terminal rows N, every start closed, "
        f"counts sum to their populations")
    tails = {k: float(res.metrics[k].mean()) for k in
             ("resp_p50", "resp_p95", "resp_p99", "qdepth_p99")}
    log("4 traced", f"mean tail columns over replicas {json.dumps(tails)}")
    i = int(torch.argmax(res.metrics["preempted"] + res.metrics["requeues"]))
    out = os.path.join(ROOT, "build")
    os.makedirs(out, exist_ok=True)
    t0 = time.perf_counter()
    html = viz.html_report(st, dynamics=res.replicas.dynamics,
                           metrics=st.metrics, replica=i,
                           title=f"E2C port, traced replica {i}")
    dash = viz.metrics_dashboard(st.metrics, replica=i)
    for name, text in (("traced_report.html", html),
                       ("traced_dashboard.svg", dash)):
        viz.save(os.path.join(out, name), text)
        log("4 traced", f"build/{name}: {len(text.encode())} bytes")
    log("4 traced", f"replica {i}: {len(T.segments(T.replica_trace(tb, i)))}"
        f" execution segments; reports rendered in "
        f"{time.perf_counter() - t0:.2f} s")


# ---------------------------------------------------------------------------
# timings
# ---------------------------------------------------------------------------
COLD_BYTES = 128 << 20     # > 2x the H100's 50 MB L2


def cold_sets(args) -> list:
    """Copies of a call's inputs, together larger than the L2 cache, so
    that calls rotating over them read their inputs from HBM."""
    size = nbytes(*[a for a in args if isinstance(a, torch.Tensor)])
    copies = max(2, min(1024, -(-COLD_BYTES // size)))
    return [tuple(a.clone() if isinstance(a, torch.Tensor) else a
                  for a in args) for _ in range(copies)]


def calls(fn, sets, kw):
    reps = max(50, len(sets))
    return reps, (lambda: [fn(*sets[i % len(sets)], **kw)
                           for i in range(reps)])


def time_ms(fn, sets, kw) -> float:
    """Stream time per call: CUDA events around back-to-back calls that
    rotate over ``sets`` (includes the host's launch cost when it exceeds
    the kernel's)."""
    reps, run = calls(fn, sets, kw)
    run()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_us(fn, args, kw) -> list:
    """Host time per wrapper call, in us, for each of 5 rounds:
    ``time.perf_counter`` around 1000 back-to-back calls on the same
    inputs, no synchronisation inside the loop (the device keeps up when
    its time per call is the smaller).  The host's other tenants make
    single rounds spread 2x, hence 5 rounds; callers report the median."""
    fn(*args, **kw)
    torch.cuda.synchronize()
    out = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(1000):
            fn(*args, **kw)
        out.append((time.perf_counter() - t0) / 1000 * 1e6)
        torch.cuda.synchronize()
    return out


def device_activity(prof) -> list:
    """(name, start_us, end_us) of every device activity a profile saw.
    Read from the profiler's raw event records: building its
    ``FunctionEvent`` tree (``prof.events()``) takes some 80 us of host
    time an event, minutes for a window of a few 100000 activities."""
    from torch.autograd import DeviceType
    return [(e.name(), e.start_ns() / 1e3,
             (e.start_ns() + e.duration_ns()) / 1e3)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]


def device_ms(fn, sets, kw) -> float:
    """Device time per call: the summed durations of every kernel the
    calls ran, from the profiler.  The profiler now and then returns a
    window without device activity (three in a row once, for 50 empty
    kernels); such a window is measured again, up to ten windows in all
    (0.0 if none saw device activity)."""
    from torch.profiler import ProfilerActivity, profile
    reps, run = calls(fn, sets, kw)
    run()
    torch.cuda.synchronize()
    for _ in range(10):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        total = sum(end - start for _, start, end in device_activity(prof))
        if total > 0:
            return total / reps / 1e3
    return 0.0


def busy_us(spans) -> float:
    """Length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for _, s, e in sorted(spans, key=lambda x: x[1]):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def nbytes(*xs) -> int:
    return sum(x.numel() * x.element_size() for x in xs)


def sector_bytes(x: torch.Tensor, sel: torch.Tensor) -> int:
    """Bytes of the 32-byte sectors of contiguous ``x`` that hold an
    element selected by ``sel`` (broadcast to ``x``'s shape)."""
    flat = torch.nonzero(sel.expand(x.shape).reshape(-1))[:, 0]
    return int(torch.unique_consecutive(
        flat * x.element_size() // SECTOR).numel()) * SECTOR


def bound(name: str, args, kw) -> tuple[float, str, int, int]:
    """The least time the card could take for one call on these inputs:
    the larger of the bytes the function must move over the HBM rate and
    its operations over the float32 rate.  Masks and statuses are read
    whole; an input the mask gates counts only the 32-byte sectors that
    hold a selected element; each output is written once.  Operations:
    one compare per selected cell (Min-Min and Max-Min add one add per
    pair, Max-Min one compare per waiting task).
    Returns (ms, "bytes" or "operations", bytes, operations)."""
    args = [a.contiguous() if isinstance(a, torch.Tensor) else a
            for a in args]
    if name == "masked_argmin":
        values, mask = args
        r = values.shape[0]
        moved = nbytes(mask) + sector_bytes(values, mask) + r * 8
        ops = int(mask.sum())
    elif name in ("fused_minmin", "fused_maxmin"):
        avail, in_batch, room, type_id, eet_m = args
        r, t = eet_m.shape[:2]
        live = in_batch.any(1) & room.any(1)           # replicas with pairs
        tasks = in_batch & live[:, None]
        used = torch.zeros((r, t), dtype=torch.int32, device=avail.device)
        used.scatter_add_(1, type_id.long(), tasks.to(torch.int32))
        cols = room & live[:, None]
        moved = (nbytes(in_batch, room) + sector_bytes(avail, cols)
                 + sector_bytes(type_id, tasks)
                 + sector_bytes(eet_m, (used > 0)[:, :, None]
                                & cols[:, None, :])
                 + r * (8 if name == "fused_minmin" else 12))
        # an add and a compare per valid pair (Max-Min: and one compare
        # per waiting task for the argmax)
        ops = 2 * int((tasks.sum(1) * cols.sum(1)).sum())
        if name == "fused_maxmin":
            ops += int(tasks.sum())
    elif name == "fused_start_pick":
        status, machine, seq, n_machines = args
        queued = status == kw["in_mq"]
        moved = (nbytes(status) + sector_bytes(machine, queued)
                 + sector_bytes(seq, queued)
                 + status.shape[0] * n_machines * (4 + 1))   # pick, has
        ops = int(queued.sum())
    else:
        status, arrival, deadline = args
        waiting = status == kw["not_arrived"]
        live = (status >= kw["live_lo"]) & (status <= kw["live_hi"])
        moved = (nbytes(status) + sector_bytes(arrival, waiting)
                 + sector_bytes(deadline, live) + status.shape[0] * 8)
        ops = int(waiting.sum() + live.sum())
    by_bytes = moved / HBM_BYTES_PER_S * 1e3
    by_ops = ops / FP32_OPS_PER_S * 1e3
    if by_ops > by_bytes:
        return by_ops, "operations", moved, ops
    return by_bytes, "bytes", moved, ops


def launch_floor(build, K, name: str, args) -> dict:
    """An empty kernel (``e2c_noop``) launched at the grid the kernel's
    captured call launches: device and stream ms and host us per call,
    the floor a launch of that size cannot go under."""
    r = args[0].shape[0]
    blocks = r
    if name == "masked_argmin" and K.argmin_layout(
            args[0][0].numel(), 0, 0) != 0 or name == "fused_start_pick" \
            and K.pick_layout(args[0].shape[1], args[3], 0) != 0:
        blocks = -(-r // 8)                     # 8 replicas a CTA
    lib = build.load()

    def noop():
        build.check(lib.e2c_noop(blocks, 256, K._stream(args[0])), "noop")
    floor = {"grid": f"{blocks}x256", "ms": device_ms(noop, [()], {}),
             "stream_ms": time_ms(noop, [()], {})}
    host = host_us(noop, (), {})
    floor["host_us"] = float(np.median(host))
    log("6 timings", f"launch floor of {name}: e2c_noop at {blocks} CTAs x "
        f"256 threads: device time per call {floor['ms']:.5f} ms, stream "
        f"time per call {floor['stream_ms']:.5f} ms, host time per call "
        f"{floor['host_us']:.2f} us (rounds {min(host):.2f}-"
        f"{max(host):.2f}); {gpu_line()}")
    return floor


def timings(K, KREF, build, launches, captured, errs, paths=PATHS) -> list:
    """One kernels-JSON row per scheduling kernel; ``launches`` and
    ``captured`` map each sweep path to its counts and captured inputs."""
    rows = []
    for name in K.NAMES:
        caps = [(f"{path} {call}", args, kw) for path in paths
                for call, args, kw in captured[path][name]]
        if not caps:
            raise AssertionError(f"no captured main-path input for {name}")
        # the captured call with the most work: the bound and the times
        # then describe the kernel under load, not an empty queue
        call, args, kw = max(caps, key=lambda c: bound(name, c[1], c[2])[3])
        kernel = getattr(K, name)
        plain = getattr(KREF, name + "_ref")
        saved = dict(K.launches)
        sets = cold_sets(args)
        stream_ms = time_ms(kernel, sets, kw)
        plain_stream_ms = time_ms(plain, sets, kw)
        ms = device_ms(kernel, sets, kw)
        plain_ms = device_ms(plain, sets, kw)
        del sets
        host_rounds = host_us(kernel, args, kw)
        host = float(np.median(host_rounds))
        floor = launch_floor(build, K, name, args)
        K.launches.update(saved)
        if ms <= 0.0 or plain_ms <= 0.0 or floor["ms"] <= 0.0:
            raise AssertionError(f"{name}: the profiler saw no device time")
        bound_ms, bound_by, moved, ops = bound(name, args, kw)
        shape = ", ".join("x".join(map(str, a.shape)) for a in args
                          if isinstance(a, torch.Tensor))
        log("6 timings", f"{name} at the main path's {shape} (call {call}), "
            f"inputs cold in L2: "
            f"device time per call (profiler) kernel {ms:.5f} ms, plain "
            f"{plain_ms:.5f} ms; stream time per call (CUDA events) kernel "
            f"{stream_ms:.5f} ms, plain {plain_stream_ms:.5f} ms; host time "
            f"per wrapper call {host:.2f} us (rounds {min(host_rounds):.2f}-"
            f"{max(host_rounds):.2f}); bound {bound_ms:.5f} ms by "
            f"{bound_by} ({moved} bytes, {ops} operations); {gpu_line()}")
        rows.append({"name": name, "route": "cuda", "source": KERNEL_SOURCE,
                     "replaces": REPLACES[name],
                     "launches": sum(launches[p][name] for p in paths),
                     **{f"launches_{p}": launches[p][name] for p in paths},
                     "max_abs_err": errs[name],
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": None,
                     "stream_ms": stream_ms,
                     "plain_stream_ms": plain_stream_ms, "host_us": host,
                     "floor": floor})
    return rows


def fma_bound(args) -> tuple[float, str, int, int]:
    """The least time for one multiply-add call: each operand's elements
    read once and the output written once, over the HBM rate, against
    one multiply and one add an output element over the float32 rate.
    Returns (ms, "bytes" or "operations", bytes, operations)."""
    n = torch.broadcast_shapes(*(a.shape for a in args)).numel()
    moved = nbytes(*args) + 4 * n
    ops = 2 * n
    by_bytes = moved / HBM_BYTES_PER_S * 1e3
    by_ops = ops / FP32_OPS_PER_S * 1e3
    if by_ops > by_bytes:
        return by_ops, "operations", moved, ops
    return by_bytes, "bytes", moved, ops


def fma_timings(FMA, KREF, launches, captured, err, paths) -> dict:
    """The kernels-JSON row of the multiply-add, timed on the captured
    call (learned and es paths) with the most output elements: kernel,
    plain version and ``torch.addcmul`` (one PyTorch call computing
    ``acc + x * w``)."""
    caps = [(f"{p} {call}", args) for p in paths if p in FMA_PATHS
            for call, args, _ in captured[p].get("fma", ())]
    if not caps:
        raise AssertionError("no captured main-path input for fma")
    call, args = max(caps, key=lambda c: fma_bound(c[1])[3])
    saved = dict(FMA.launches)
    sets = cold_sets(args)
    res = {"stream_ms": time_ms(FMA.fma, sets, {}),
           "ms": device_ms(FMA.fma, sets, {}),
           "plain_ms": device_ms(KREF.fma_ref, sets, {}),
           "library_ms": device_ms(
               lambda x, w, acc: torch.addcmul(acc, x, w), sets, {})}
    del sets
    host = float(np.median(host_us(FMA.fma, args, {})))
    FMA.launches.update(saved)
    if res["ms"] <= 0.0 or res["plain_ms"] <= 0.0:
        raise AssertionError("fma: the profiler saw no device time")
    bound_ms, bound_by, moved, ops = fma_bound(args)
    shape = ", ".join("x".join(map(str, a.shape)) for a in args)
    log("6 timings", f"fma at the main path's {shape} (call {call}), inputs "
        f"cold in L2: device time per call (profiler) kernel "
        f"{res['ms']:.5f} ms, plain {res['plain_ms']:.5f} ms, library "
        f"(addcmul) {res['library_ms']:.5f} ms; stream time kernel "
        f"{res['stream_ms']:.5f} ms; host time per wrapper call {host:.2f} "
        f"us; bound {bound_ms:.5f} ms by {bound_by} ({moved} bytes, {ops} "
        f"operations); {gpu_line()}")
    return {"name": "fma", "route": "cuda", "source": FMA_SOURCE,
            "replaces": REPLACES["fma"],
            "launches": sum(launches[p].get("fma", 0) for p in paths),
            **{f"launches_{p}": launches[p]["fma"] for p in paths
               if p in FMA_PATHS},
            "max_abs_err": err, "ms": res["ms"],
            "plain_ms": res["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": res["library_ms"],
            "stream_ms": res["stream_ms"], "host_us": host}


def profile_window(X, E, K, dev, path, n_rep, n_tasks, n_mach, steps=32,
                   chunk=None):
    """A main path's first ``steps`` event steps at full width, under
    the profiler: wall time, device busy/idle share, top device kernels,
    and the port's kernels' device time per call in that window.  With
    ``chunk`` the run is chunked and the window holds each chunk's first
    steps and the drawing of the chunks."""
    from torch.profiler import ProfilerActivity, profile
    phase = f"4 {path} profile"
    spec = make_spec(X, E, path, n_rep, n_tasks, n_mach, max_events=steps)
    kw = {"policy_params": path_weights(path)}
    if chunk is None:
        reps = X.normalize(spec, device=dev)
        X.run_experiment(spec, device=dev, replicas=reps, **kw)   # warm-up
        kw["replicas"] = reps
    else:
        kw["chunk"] = chunk
    torch.cuda.synchronize()
    saved = dict(K.launches)
    stats = E.RunStats()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        X.run_experiment(spec, device=dev, stats=stats, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    K.launches.update(saved)
    spans = device_activity(prof)
    busy = busy_us(spans) / 1e6
    log(phase, f"{stats.events} event steps, {stats.drain_trips} drain "
        f"trips, {stats.host_reads} host reads: wall {wall:.3f} s, device "
        f"busy {busy:.3f} s ({100 * busy / wall:.1f}%, idle "
        f"{100 * (1 - busy / wall):.1f}%), {len(spans)} device activities "
        f"({len(spans) / max(stats.events, 1):.0f} per event step); "
        f"{gpu_line()}")
    by_name: dict = {}
    for name, s, e in spans:
        tot, cnt = by_name.get(name, (0.0, 0))
        by_name[name] = (tot + e - s, cnt + 1)
    for name, (tot, cnt) in sorted(by_name.items(),
                                   key=lambda kv: -kv[1][0])[:8]:
        log(phase, f"{tot / 1e3:10.2f} ms {cnt:7d} x  {name[:90]}")
    for kname in K.NAMES:
        # every layout's kernel: masked_argmin_warp_kernel<true>, ...
        hits = [(t, c) for n, (t, c) in by_name.items()
                if kname in n and "_kernel" in n]
        if hits:
            t, c = sum(h[0] for h in hits), sum(h[1] for h in hits)
            log(phase, f"in the main path: {kname} {c} calls, "
                f"{t / c / 1e3:.5f} ms device time each")


# ---------------------------------------------------------------------------
# model kernels: flash attention and the grouped matmul
# ---------------------------------------------------------------------------
MODEL_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
ZERO_LEAF_NOISE = 0.1   # the serving weights' noise on zero leaves


def check_close(name: str, got: torch.Tensor, want: torch.Tensor,
                atol: float, rtol: float) -> float:
    """Raise unless ``got`` is close to ``want``; returns the largest
    absolute difference."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {got.dtype} {tuple(got.shape)} != "
                             f"{want.dtype} {tuple(want.shape)}")
    g, w = got.float(), want.float()
    if not torch.allclose(g, w, atol=atol, rtol=rtol):
        bad = (~torch.isclose(g, w, atol=atol, rtol=rtol)).nonzero()[:5]
        raise AssertionError(f"{name}: kernel not within atol {atol} rtol "
                             f"{rtol} of plain at {bad.tolist()}")
    return float((g - w).abs().max()) if g.numel() else 0.0


def raw_bits(x: torch.Tensor) -> torch.Tensor:
    """The bits of a float tensor as integers of the same width."""
    return x.view({4: torch.int32, 2: torch.int16}[x.element_size()])


def check_model_call(mods, name: str, args, kw, label: str) -> float:
    """One model-kernel call against its plain version, at the stated
    tolerance, and against a second launch on the same inputs, bit for
    bit; grouped-matmul rows past the size must be exactly 0."""
    mod = mods[name]
    got = getattr(mod, name)(*args, **kw)
    again = getattr(mod, name)(*args, **kw)
    torch.cuda.synchronize()
    if not torch.equal(raw_bits(got), raw_bits(again)):
        raise AssertionError(f"{name} {label}: two launches on the same "
                             "inputs differ")
    want = getattr(mod, name + "_ref")(*args, **kw)
    tol = MODEL_TOL[args[0].dtype]
    if name == "flash_attention":
        return check_close(f"{name} {label}", got, want, tol, tol)
    lhs, _, sizes = args
    err = check_close(f"{name} {label}", got, want, tol * lhs.shape[2], tol)
    pad = torch.arange(lhs.shape[1], device=lhs.device)[None, :] \
        >= sizes[:, None]
    if not bool((got[pad] == 0).all()):
        raise AssertionError(f"{name} {label}: a padding row is not 0")
    return err


def model_kernel_cases(dev):
    """(name, label, args, kwargs) cases of the two model kernels."""
    g = torch.Generator(device="cpu").manual_seed(2)
    six_live = [1 if i % 11 == 0 else 0 for i in range(64)]
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        dn = "f32" if dtype == torch.float32 else "bf16"

        def rnd(*shape):
            return torch.randn(shape, generator=g).to(dev, dtype)
        for bh, sq, sk, hd, kw, what in (
                (3, 128, 128, 64, {"causal": True}, "causal"),
                (3, 130, 130, 128, {"causal": True}, "ragged S"),
                (2, 64, 256, 128, {"causal": False}, "non-causal Sq<Sk"),
                (2, 200, 77, 64, {"causal": True}, "causal Sq>Sk"),
                (3, 37, 53, 16, {"causal": True}, "odd shapes"),
                (2, 256, 256, 256, {"causal": True}, "hd 256"),
                (2, 192, 192, 32, {"causal": True, "window": 64}, "window"),
                (2, 100, 100, 128, {"causal": False, "window": 30},
                 "non-causal window"),
                (2, 64, 64, 32, {"causal": True, "softcap": 20.0},
                 "softcap"),
                (1, 512, 512, 128, {"causal": True, "softcap": 30.0},
                 "softcap 30 at hd 128"),
                (1, 384, 384, 256, {"causal": False, "window": 100,
                                    "softcap": 20.0},
                 "softcap 20, window 100 at hd 256"),
                (2, 96, 32, 32, {"causal": True, "window": 16},
                 "rows with no visible key"),
                (2, 64, 10, 128, {"causal": False},
                 "Sk below one key stage"),
                (2, 96, 129, 128, {"causal": False},
                 "Sk = 2 stages x 64 + 1 (f32 hd <= 128 stages)"),
                (2, 80, 129, 64, {"causal": False},
                 "Sk = 2 stages x 64 + 1 at hd 64"),
                (2, 96, 257, 128, {"causal": False},
                 "Sk = 2 stages x 128 + 1 (bf16 hd <= 128 stages)"),
                (2, 80, 33, 256, {"causal": False},
                 "Sk = 2 stages x 16 + 1 (f32 hd 256 stages)"),
                (2, 1000, 1000, 128, {"causal": True}, "ragged S 1000"),
                (2, 300, 300, 256, {"causal": True}, "hd 256, ragged S"),
                (2, 50, 50, 37, {"causal": True},
                 "hd 37: rows not 16-byte multiples"),
                (12, 1024, 1024, 128, {"causal": True},
                 "qwen2-1.5b prefill shape"),
                (2, 100, 100, 96, {"causal": True}, "hd 96, ragged S"),
                (2, 70, 130, 96, {"causal": False}, "hd 96, Sq < Sk"),
                (3, 1, 77, 64, {"causal": False}, "one query, hd 64"),
                (3, 1, 130, 96, {"causal": False}, "one query, hd 96"),
                (4, 1, 1024, 128, {"causal": False},
                 "decode route, one query, hd 128"),
                (3, 4, 200, 64, {"causal": True},
                 "decode route, 4 causal queries"),
                (2, 3, 65, 37, {"causal": True, "window": 2},
                 "decode route, window 2, hd 37, 64 + 1 keys"),
                (2, 1, 10, 256, {"causal": False, "softcap": 20.0},
                 "decode route, softcap, hd 256, 10 keys"),
                (2, 5, 130, 64, {"causal": False},
                 "5 queries: the tiled kernel"),
                *(((16, 2048, 2048, 256, {"causal": True, "window": 1024},
                    "gemma3-12b local prefill, S = 2048 > window"),
                   (10, 2048, 2048, 256, {"causal": True, "window": 2048},
                    "recurrentgemma-2b local prefill, window = S"),
                   (16, 1024, 1024, 64, {"causal": False},
                    "seamless encoder, non-causal, 16 heads x 64"),
                   (16, 512, 1024, 64, {"causal": False},
                    "seamless cross-attention prefill, 512 queries, 1024 "
                    "frames"),
                   (16, 1, 1024, 64, {"causal": False},
                    "seamless cross-attention decode, one query"),
                   (16, 1024, 1024, 64, {"causal": True},
                    "seamless decoder prefill"),
                   (32, 1024, 1024, 96, {"causal": True},
                    "phi-3-vision prefill, 32 heads x 96"),
                   (64, 1024, 1024, 128, {"causal": True},
                    "command-r / qwen2-72b / qwen3-moe prefill, 64 heads "
                    "x 128"))
                  if dtype == torch.float32 else ())):
            cases.append(("flash_attention", f"{dn} {what} {bh}x{sq}x{sk}x"
                          f"{hd}", (rnd(bh, sq, hd), rnd(bh, sk, hd),
                                    rnd(bh, sk, hd)), kw))
        for gr, c, d, f, sizes, what in (
                (4, 40, 96, 72, [0, 13, 40, 1], "sizes 0, partial, full"),
                (8, 128, 64, 128, [128, 0, 64, 65, 1, 127, 3, 0],
                 "tile edges"),
                (3, 33, 48, 40, [33, 0, 17], "C, F not tile multiples"),
                (4, 32, 16, 24, [0, 0, 0, 0], "all groups empty"),
                (64, 8, 2048, 200, six_live, "decode-like, 6 live groups"),
                (8, 16, 256, 384, [16, 0, 5, 1, 9, 16, 0, 2],
                 "C = 16, decode kernel"),
                (8, 17, 256, 384, [17, 0, 5, 1, 9, 16, 0, 2],
                 "C = 17, tiled kernel"),
                (3, 7, 21, 13, [7, 1, 0], "D, F not 16-byte rows, decode"),
                (3, 20, 21, 13, [20, 1, 0], "D, F not 16-byte rows, tiled"),
                (3, 200, 36, 34, [200, 70, 64],
                 "two row tiles, D and F past the last slice and tile"),
                (64, 8, 2048, 2816, six_live, "decode w_in, 6 live groups"),
                (64, 8, 2048, 2816, [0] * 64, "decode w_in, none live"),
                (64, 8, 1408, 2048, six_live, "decode w_out, 6 live groups"),
                (64, 8, 1408, 2048, [0] * 64, "decode w_out, none live")):
            sz = torch.tensor(sizes, dtype=torch.int32, device=dev)
            cases.append(("grouped_matmul", f"{dn} {what} {gr}x{c}x{d}x{f}",
                          (rnd(gr, c, d), rnd(gr, d, f), sz), {}))
    cases += qwen3_moe_cases(dev)
    return cases


def qwen3_moe_cases(dev):
    """The grouped matmul at qwen3-moe-235b-a22b's shapes, f32: G = 128
    experts, d 4096 -> 2 x 1536 -> 4096, at a 1024-token prefill (top-8,
    capacity 80, the 8192 assignments spread over the experts, some
    groups full and some empty) and at a decode step (8 live groups of
    one row of C = 8).  One pair of expert weights (6.4 + 3.2 GB) serves
    both, drawn on the card."""
    G, D, F, C = 128, 4096, 1536, 80
    g = torch.Generator().manual_seed(3)
    gd = torch.Generator(dev).manual_seed(3)

    def rnd(*shape, std=1.0):
        return torch.randn(shape, generator=gd, device=dev) * std
    w_in = rnd(G, D, 2 * F, std=D ** -0.5)
    w_out = rnd(G, F, D, std=F ** -0.5)
    counts = torch.multinomial(torch.ones(G), 8192, replacement=True,
                               generator=g).bincount(minlength=G)
    prefill = torch.clamp(counts, max=C)
    prefill[:3] = torch.tensor([0, C, 1])
    decode = torch.zeros(G, dtype=torch.int64)
    decode[torch.randperm(G, generator=g)[:8]] = 1
    cases = []
    for c, sizes, what in ((C, prefill, "prefill"), (8, decode, "decode")):
        sz = sizes.to(torch.int32).to(dev)
        x_in, x_out = rnd(G, c, D), rnd(G, c, F)
        cases.append(("grouped_matmul", f"f32 qwen3-moe {what} w_in "
                      f"{G}x{c}x{D}x{2 * F}", (x_in, w_in, sz), {}))
        cases.append(("grouped_matmul", f"f32 qwen3-moe {what} w_out "
                      f"{G}x{c}x{F}x{D}", (x_out, w_out, sz), {}))
    return cases


def check_model_kernels(mods, dev) -> dict:
    errs = dict.fromkeys(MODEL_KERNELS, 0.0)
    for name, label, args, kw in model_kernel_cases(dev):
        errs[name] = max(errs[name],
                         check_model_call(mods, name, args, kw, label))
        log("3 kernels", f"{name} {label}: within tolerance, max abs err "
            f"{errs[name]:.3g}")
    return errs


def model_bound(name: str, args, kw) -> tuple[float, str, int, int]:
    """The least time the card could take for one call on these inputs,
    the larger of bytes over the HBM rate and operations over the
    tensor-core rate of the inputs' type: f32 products at the 3xTF32
    rate, 495 / 3 = 165 TFLOP/s (single-pass TF32 misses the f32
    tolerance, 3xTF32 meets it: tests/test_torch_tf32_split.py, so that
    is the fastest way the card can meet the contract), bf16 at 989.
    flash_attention: 4 * BH * hd operations per visible (q, k) pair;
    q, k, v read once and o written once.  grouped_matmul: 2 * D * F
    operations per live row; the live groups' rhs, the live rows of lhs
    and the sizes read once, the whole output written once.
    Returns (ms, "bytes" or "operations", bytes, operations)."""
    if name == "flash_attention":
        from repro_torch.kernels.flash_attention import visible_mask
        q, k, v = args
        pairs = int(visible_mask(q.shape[1], k.shape[1],
                                 causal=kw.get("causal", True),
                                 window=kw.get("window", 0),
                                 device=q.device).sum())
        ops = 4 * q.shape[0] * q.shape[2] * pairs
        moved = 2 * nbytes(q) + nbytes(k, v)
    else:
        lhs, rhs, sizes = args
        g, c, d = lhs.shape
        f = rhs.shape[2]
        live = torch.clamp(sizes.long(), 0, c)
        rows = int(live.sum())
        ops = 2 * rows * d * f
        moved = (int((live > 0).sum()) * d * f * rhs.element_size()
                 + rows * d * lhs.element_size() + nbytes(sizes)
                 + g * c * f * lhs.element_size())
    rate = BF16_OPS_PER_S if args[0].dtype == torch.bfloat16 \
        else TF32X3_OPS_PER_S
    by_bytes = moved / HBM_BYTES_PER_S * 1e3
    by_ops = ops / rate * 1e3
    if by_ops > by_bytes:
        return by_ops, "operations", moved, ops
    return by_bytes, "bytes", moved, ops


def sdpa(q, k, v, causal: bool):
    """``scaled_dot_product_attention`` on the (1, BH, S, hd) views of
    (BH, S, hd) inputs, its fused kernel pinned: FlashAttention-2 for
    bf16, the memory-efficient kernel for f32 (flash takes no f32).  The
    fused kernels take 4-D inputs only, and a 3-D call runs the math
    fallback that builds the S x S matrix; pinned, a shape the fused
    kernel refuses raises instead of timing that fallback."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    backend = SDPBackend.FLASH_ATTENTION if q.dtype == torch.bfloat16 \
        else SDPBackend.EFFICIENT_ATTENTION
    with sdpa_kernel(backend):
        return F.scaled_dot_product_attention(q[None], k[None], v[None],
                                              is_causal=causal)[0]


def library_call(name: str, args, kw):
    """One PyTorch call computing the same function, or None (a window
    or a softcap; causal with Sq != Sk, where SDPA's mask is aligned its
    own way)."""
    if name == "grouped_matmul":
        # the MoE buffers' padding rows are zero, so bmm agrees there
        return lambda lhs, rhs, sizes: torch.bmm(lhs, rhs)
    causal = kw.get("causal", True)
    if kw.get("window") or kw.get("softcap") \
            or (causal and args[0].shape[1] != args[1].shape[1]):
        return None
    return lambda q, k, v, **_: sdpa(q, k, v, causal)


# ---------------------------------------------------------------------------
# the serving path
# ---------------------------------------------------------------------------
SERVE_EET = np.array([[1.0, 2.0], [3.0, 1.5]], np.float32)  # type x mtype
SERVE_POWER = np.array([[50.0, 200.0], [30.0, 120.0]], np.float32)
SERVE_MTYPES = (0, 0, 1, 1)


SERVE_SHAPES = {"serve": (1024, 32), "serve_gemma": (2048, 32),
                "serve_xlstm": (1024, 32), "serve_wide": (1024, 32),
                FRONTENDS: (1024, 32)}
SERVE_TINY_SHAPE = (40, 6)    # prompt past the tiny window of 16


def serve_archs(path: str, tiny: bool):
    """The two apps of a serving path.  ``serve``: qwen2-1.5b as
    published and deepseek-moe-16b at its published widths cut to 8
    layers (1 dense + 7 MoE).  ``serve_gemma``: gemma3-12b and
    recurrentgemma-2b as published (48 layers; 26 layers, 8 cycles of
    (rec, rec, local) and 2 ``rec`` layers).  ``serve_xlstm``:
    xlstm-350m as published (24 layers, 6 cycles of (mlstm, mlstm,
    mlstm, slstm)) and qwen2-72b at its published widths cut to 4 of 80
    layers.  ``serve_wide``: command-r-35b at its published widths cut
    to 4 of 40 layers and qwen3-moe-235b-a22b cut to 2 of 94.
    ``frontends``: seamless-m4t-large-v2 (24 encoder + 24 decoder
    layers) and phi-3-vision-4.2b (32 layers), both as published.  The
    cuts keep all of a path's f32 weights on the card beside the
    activations.  Tiny forms: the configs' ``tiny()``, recurrentgemma
    cut to 8 layers so that its stack keeps a suffix."""
    from repro_torch.configs.base import get_arch
    names, cuts = {
        "serve": (("qwen2-1.5b", "deepseek-moe-16b"), (None, 8)),
        "serve_gemma": (("gemma3-12b", "recurrentgemma-2b"), (None, None)),
        "serve_xlstm": (("xlstm-350m", "qwen2-72b"), (None, 4)),
        "serve_wide": (("command-r-35b", "qwen3-moe-235b-a22b"), (4, 2)),
        FRONTENDS: (("seamless-m4t-large-v2", "phi-3-vision-4.2b"),
                    (None, None))}[path]
    cfgs = [get_arch(n) for n in names]
    if tiny:
        return tuple(c.tiny(n_layers=8) if c.name == "recurrentgemma-2b"
                     else c.tiny() for c in cfgs)
    return tuple(c if n is None else dataclasses.replace(c, n_layers=n)
                 for c, n in zip(cfgs, cuts))


def live_params(tree, gen):
    """``tree`` with seeded noise of scale ``ZERO_LEAF_NOISE`` in place of
    every all-zero leaf (biases, conv taps, norm offsets, which the
    initializers set to 0), drawn from ``gen`` on the leaf's device.
    With zero conv taps every mLSTM and sLSTM block adds exactly 0, and
    a check of such a model passes whatever those blocks compute."""
    if isinstance(tree, dict):
        return {k: live_params(v, gen) for k, v in tree.items()}
    if isinstance(tree, list):
        return [live_params(v, gen) for v in tree]
    if bool(tree.any()):
        return tree
    return ZERO_LEAF_NOISE * torch.randn(tree.shape, generator=gen,
                                         device=tree.device,
                                         dtype=tree.dtype)


def model_params(cfg, dev, seed: int):
    """Random weights drawn on ``dev`` from ``seed``, zero leaves noised
    (``live_params``), every xLSTM block checked to add to its input
    (``check_xlstm_live``)."""
    from repro_torch.models import model as M
    gen = torch.Generator(dev).manual_seed(seed)
    params = live_params(M.init_params(gen, cfg), gen)
    check_xlstm_live(params, cfg)
    return params


def check_xlstm_live(params, cfg) -> None:
    """Raise unless every mLSTM and sLSTM block of the stack gives a
    nonzero output on a seeded input."""
    from repro_torch.models import model as M
    from repro_torch.models import xlstm as XL
    lay = M.layout(cfg)
    dev = params["embed"]["table"].device
    x = torch.randn((1, 6, cfg.d_model),
                    generator=torch.Generator(dev).manual_seed(0),
                    device=dev)
    for part, kinds in (("prefix", lay.prefix), ("cycle", lay.cycle),
                        ("suffix", lay.suffix)):
        for j, kind in enumerate(kinds):
            if kind not in ("mlstm", "slstm"):
                continue
            blocks = params["stack"][part][j]
            for i, p in enumerate(blocks if part == "cycle" else [blocks]):
                fn = XL.apply_mlstm_block if kind == "mlstm" \
                    else XL.apply_slstm_block
                top = float(fn(p["cell"], x, cfg.n_heads)[0].abs().max())
                if not top > 1e-3:
                    raise AssertionError(
                        f"{cfg.name}: {kind} block {part}[{j}][{i}] "
                        f"outputs at most {top:.3g}: a degenerate model")


def serve_apps(cfgs, dev, prompt_len, gen_len):
    from repro_torch.serving import AppSpec
    return [AppSpec(cfg.name, gen_len=gen_len, arch=cfg,
                    params=model_params(cfg, dev, seed),
                    prompt_len=prompt_len)
            for seed, cfg in enumerate(cfgs)]


def serve_workload(n: int, seed: int = 0):
    from repro_torch.core.workload import poisson_workload
    wl = poisson_workload(n, rate=0.5, n_task_types=2,
                          mean_eet=SERVE_EET.mean(1), slack=60.0,
                          seed=seed)
    if set(wl.type_id.tolist()) != {0, 1}:
        raise AssertionError("the serving workload lacks a task type")
    return wl


def n_params(tree) -> int:
    if isinstance(tree, dict):
        return sum(n_params(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(n_params(v) for v in tree)
    return tree.numel()


def expected_launches(apps, type_ids) -> dict:
    """Launches the shapes imply.  Flash attention: one per attention
    layer (all but ``rec``, ``mlstm`` and ``slstm``) of a prefill; for an
    encoder-decoder also one per encoder layer, and one cross-attention
    per decoder layer of a prefill and of each of the ``gen_len`` decode
    steps.  Grouped matmul: two per MoE layer of a prefill and of each
    decode step."""
    out = dict.fromkeys(MODEL_KERNELS, 0)
    for t in type_ids:
        app = apps[int(t)]
        cfg, kinds = app.arch, app.arch.kinds()
        out["flash_attention"] += sum(k not in ("rec", "mlstm", "slstm")
                                      for k in kinds)
        if cfg.is_encdec:
            out["flash_attention"] += cfg.n_encoder_layers \
                + len(kinds) * (1 + app.gen_len)
        out["grouped_matmul"] += 2 * kinds.count("moe") * (1 + app.gen_len)
    return out


def frontend_batch(cfg, task: int, prompt_len: int, dev) -> dict:
    """One request of the frontends path, drawn from
    ``numpy.random.default_rng(task)``: a prompt, for an encoder-decoder
    ``prompt_len`` frames of width d, for a vision model its
    ``n_frontend_tokens`` patch embeddings, frames and patches at the
    token embeddings' scale d**-0.5."""
    rng = np.random.default_rng(task)
    std = cfg.d_model ** -0.5
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (1, prompt_len))}
    if cfg.is_encdec:
        batch["frames"] = (std * rng.standard_normal(
            (1, prompt_len, cfg.d_model))).astype(np.float32)
    if cfg.frontend == "vision":
        batch["patch_embeds"] = (std * rng.standard_normal(
            (1, cfg.n_frontend_tokens, cfg.d_model))).astype(np.float32)
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


class FrontendServer:
    """The frontends path's driver: each request's ``models/model.py``
    ``prefill`` (with its frames or patch embeddings) and ``gen_len``
    greedy ``decode_step``s with f32 activations, as the serving engine's
    ``_execute`` runs a request.  The engine passes a request's tokens
    alone, as the reference's does, so an encoder-decoder cannot be
    served through it (ROADMAP queue C)."""

    def __init__(self, apps, dev):
        self.apps, self.dev = apps, dev
        self.outputs: dict = {}
        self.tokens_generated = 0

    def run(self, type_ids) -> None:
        from repro_torch.models import model as M
        opt = M.ModelOptions(dtype=torch.float32)
        for task, t in enumerate(type_ids):
            app = self.apps[int(t)]
            cfg = app.arch
            batch = frontend_batch(cfg, task, app.prompt_len, self.dev)
            logits, cache = M.prefill(app.params, batch, cfg, opt,
                                      cache_len=app.prompt_len
                                      + app.gen_len)
            toks = []
            tok = torch.argmax(logits[:, -1], -1)[:, None]
            for _ in range(app.gen_len):
                toks.append(int(tok[0, 0]))
                logits, cache = M.decode_step(app.params, cache, tok, cfg,
                                              opt)
                tok = torch.argmax(logits[:, -1], -1)[:, None]
            if not bool(torch.isfinite(logits).all()):
                raise AssertionError(f"{app.name} request {task}: logits "
                                     "not finite")
            self.outputs[task] = np.asarray(toks, np.int32)
            self.tokens_generated += app.gen_len


def serve_driver(path: str, apps, dev):
    """-> run(requests): one run of the path's driver over a workload
    (``arrival``, ``type_id``, ``deadline``), returning (completed,
    tokens generated, {task: tokens}, the report row or None): the
    ``ServingEngine`` (ee_mct, run_mode real) or, for ``frontends``, a
    ``FrontendServer`` taking the requests in order."""
    from repro_torch.serving import ServeConfig, ServingEngine

    def run(requests):
        if path == FRONTENDS:
            server = FrontendServer(apps, dev)
            server.run(requests.type_id)
            return (len(server.outputs), server.tokens_generated,
                    server.outputs, None)
        engine = ServingEngine(SERVE_EET, SERVE_POWER, list(SERVE_MTYPES),
                               apps, ServeConfig(policy="ee_mct",
                                                 run_mode="real"),
                               device=dev)
        rep = engine.run(requests)
        return rep.completed, rep.tokens_generated, engine.outputs, rep.row()
    return run


def serve_requests(path: str, n: int, seed: int = 0):
    """The path's requests: ``n`` Poisson requests of the two apps; the
    frontends path takes ``FRONTEND_REQUESTS`` of each app instead."""
    if path != FRONTENDS:
        return serve_workload(n, seed)
    from repro_torch.core.workload import Workload
    k = 2 * FRONTEND_REQUESTS
    return Workload(np.zeros(k, np.float32),
                    np.repeat(np.arange(2), FRONTEND_REQUESTS),
                    np.full(k, 1e6, np.float32))


@contextlib.contextmanager
def kernel_capture(targets):
    """Within the block, the inputs of the first call of each input shape
    (and keywords) of each wrapper ``getattr(mod, name)`` of ``targets``
    (``(mod, name)`` pairs), in ``{name: [(call, args, kwargs), ...]}``
    with the call's number among that wrapper's calls.  The inputs are
    held detached, not copied: the port writes none of them after the
    call."""
    captured = {name: [] for _, name in targets}
    kernels = [(mod, name, getattr(mod, name)) for mod, name in targets]

    def capture(name, fn):
        seen, count = set(), [0]

        def wrapped(*args, **kw):
            count[0] += 1
            key = tuple(tuple(a.shape) for a in args
                        if isinstance(a, torch.Tensor)) \
                + tuple(sorted(kw.items()))
            if key not in seen:
                seen.add(key)
                captured[name].append((count[0], tuple(
                    a.detach() if isinstance(a, torch.Tensor) else a
                    for a in args), dict(kw)))
            return fn(*args, **kw)
        return wrapped

    for mod, name, fn in kernels:
        setattr(mod, name, capture(name, fn))
    try:
        yield captured
    finally:
        for mod, name, fn in kernels:
            setattr(mod, name, fn)


@contextlib.contextmanager
def serve_hooks(M, mods):
    """Within the block: the synchronised host time of every ``prefill``
    and ``decode_step`` by model name, and the model kernels' captured
    inputs (``kernel_capture``)."""
    times: dict = {}
    orig = {"prefill": M.prefill, "decode_step": M.decode_step}

    def timed(kind, fn, cfg_at):
        def wrapped(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            times.setdefault(args[cfg_at].name, {"prefill": [],
                                                 "decode_step": []})[
                kind].append(time.perf_counter() - t0)
            return out
        return wrapped

    M.prefill = timed("prefill", orig["prefill"], 2)
    M.decode_step = timed("decode_step", orig["decode_step"], 3)
    try:
        with kernel_capture([(mods[name], name)
                             for name in MODEL_KERNELS]) as captured:
            yield times, captured
    finally:
        M.prefill, M.decode_step = orig["prefill"], orig["decode_step"]


def run_serve(mods, dev, path: str, tiny: bool, n_requests: int = 8):
    """Drive serving path ``path`` once through its driver
    (``serve_driver``), the model kernels' launch counts set to 0 just
    before and read just after; returns the apps, the launches and the
    captured inputs."""
    from repro_torch.models import model as M
    phase = f"4 {path}"
    prompt_len, gen_len = SERVE_TINY_SHAPE if tiny else SERVE_SHAPES[path]
    cfgs = serve_archs(path, tiny)
    t0 = time.perf_counter()
    apps = serve_apps(cfgs, dev, prompt_len, gen_len)
    torch.cuda.synchronize()
    for app in apps:
        enc = f" + {app.arch.n_encoder_layers} encoder" \
            if app.arch.is_encdec else ""
        log(phase, f"{app.name}: {app.arch.n_layers}{enc} layers "
            f"({', '.join(sorted(set(app.arch.kinds())))}), d "
            f"{app.arch.d_model}, heads {app.arch.n_heads}/"
            f"{app.arch.n_kv_heads} x {app.arch.hd}, vocab "
            f"{app.arch.vocab_size}: {n_params(app.params) / 1e9:.3f} B "
            f"parameters in f32")
    log(phase, f"weights drawn on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    wl = serve_requests(path, n_requests)
    run = serve_driver(path, apps, dev)
    torch.cuda.reset_peak_memory_stats()
    with serve_hooks(M, mods) as (times, captured):
        for mod in mods.values():
            mod.reset_launches()
        t0 = time.perf_counter()
        completed, tokens, outputs, row = run(wl)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: mods[name].launches[name]
                    for name in MODEL_KERNELS}
    peak = torch.cuda.max_memory_allocated() / 2**30
    n = len(wl.type_id)
    if row is not None:
        log(phase, json.dumps(row))
    log(phase, f"{completed} of {n} requests completed, {tokens} tokens "
        f"generated in {wall:.3f} s (synchronised); peak device memory "
        f"{peak:.2f} GiB (both apps' weights, caches and activations); "
        f"{gpu_line()}")
    for app in apps:
        t = times.get(app.name)
        if t is None:
            raise AssertionError(f"{app.name} served no request")
        log(phase, f"{app.name}: {len(t['prefill'])} of {completed} "
            f"completed requests; prefill {1e3 * np.mean(t['prefill']):.2f} "
            f"ms a request over {len(t['prefill'])} requests of "
            f"{prompt_len} tokens, decode "
            f"{1e3 * np.mean(t['decode_step']):.3f} ms a token over "
            f"{len(t['decode_step'])} steps (synchronised)")
    want = expected_launches(apps, wl.type_id)
    log(phase, f"kernel launches {json.dumps(launches)}, implied by the "
        f"shapes {json.dumps(want)}")
    if completed != n or len(outputs) != n:
        raise AssertionError(f"{completed} of {n} requests completed")
    if tokens != sum(apps[t].gen_len for t in wl.type_id):
        raise AssertionError("tokens generated != the requests' decode "
                             "lengths")
    for task, toks in outputs.items():
        vocab = apps[int(wl.type_id[task])].arch.vocab_size
        if toks.shape != (gen_len,) or not ((toks >= 0)
                                            & (toks < vocab)).all():
            raise AssertionError(f"request {task}: tokens {toks}")
    if launches != want:
        raise AssertionError(f"launches {launches} != implied {want}")
    return apps, launches, captured


def recheck_model_captured(mods, captured, path) -> dict:
    errs = dict.fromkeys(MODEL_KERNELS, 0.0)
    for name in MODEL_KERNELS:
        for call, args, kw in captured[name]:
            shape = "x".join(map(str, args[0].shape))
            err = check_model_call(mods, name, args, kw,
                                   f"{path} call {call} ({shape})")
            errs[name] = max(errs[name], err)
            log("3 kernels", f"{name} captured at {path}-path call {call} "
                f"({shape} {kw}): within tolerance, max abs err {err:.3g}")
    return errs


def lost_records(spans, n_calls: dict) -> str | None:
    """What a profiled window lacks, or None when it holds one first
    kernel for each wrapper call of each model kernel and one reduction
    for each split-D kernel (the grouped matmul's decode shapes)."""
    for kname, n in n_calls.items():
        names = [s[0] for s in spans if kname in s[0] and "_kernel" in s[0]]
        reduce = sum("_reduce_kernel" in x for x in names)
        decode = sum("_decode_kernel" in x for x in names)
        if len(names) - reduce != n or reduce != decode:
            return (f"the profiler saw {len(names) - reduce} {kname} "
                    f"launches for {n} calls and {reduce} reductions for "
                    f"{decode} split-D kernels")
    return None


def profile_serve(mods, apps, dev, path: str) -> dict:
    """One request of each app under the profiler, one app at a time:
    wall time, device busy/idle share and the top device kernels of each,
    and each model kernel's device time per call inside the runs.  A
    window that lost device records (the profiler drops some now and
    then) is profiled again, up to ``PROFILE_TRIES`` windows in all."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.workload import Workload
    phase = f"4 {path} profile"
    run = serve_driver(path, apps, dev)
    saved = {name: dict(mods[name].launches) for name in MODEL_KERNELS}
    by_name: dict = {}
    n_calls = dict.fromkeys(MODEL_KERNELS, 0)
    for type_id, app in enumerate(apps):
        wl = Workload(np.array([0.0], np.float32), np.array([type_id]),
                      np.array([1e6], np.float32))
        for _ in range(PROFILE_TRIES):
            before = {k: mods[k].launches[k] for k in MODEL_KERNELS}
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                run(wl)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            calls = {k: mods[k].launches[k] - before[k]
                     for k in MODEL_KERNELS}
            spans = device_activity(prof)
            lost = lost_records(spans, calls)
            if lost is None:
                break
            log(phase, f"one request of {app.name}: {lost}; profiled again")
        else:
            raise AssertionError(f"{lost} in each of {PROFILE_TRIES} "
                                 f"windows")
        for k in MODEL_KERNELS:
            n_calls[k] += calls[k]
        busy = busy_us(spans) / 1e6
        log(phase, f"one request of {app.name}: wall {wall:.3f} s, device "
            f"busy {busy:.3f} s ({100 * busy / wall:.1f}%, idle "
            f"{100 * (1 - busy / wall):.1f}%), {len(spans)} device "
            f"activities; {gpu_line()}")
        mine: dict = {}
        for name, s0, e in spans:
            tot, cnt = mine.get(name, (0.0, 0))
            mine[name] = (tot + e - s0, cnt + 1)
            tot, cnt = by_name.get(name, (0.0, 0))
            by_name[name] = (tot + e - s0, cnt + 1)
        for name, (tot, cnt) in sorted(mine.items(),
                                       key=lambda kv: -kv[1][0])[:10]:
            log(phase, f"{tot / 1e3:10.2f} ms {cnt:7d} x  {name[:90]}")
    for name in MODEL_KERNELS:
        mods[name].launches.update(saved[name])
    in_run = {}
    for kname in MODEL_KERNELS:
        if not n_calls[kname]:
            continue
        # every kernel a wrapper call launches (the grouped matmul's
        # decode shapes run a split-D kernel and its reduction), each
        # window holding all of them (``lost_records``)
        hits = {n: (t, c) for n, (t, c) in by_name.items()
                if kname in n and "_kernel" in n}
        t = sum(h[0] for h in hits.values())
        in_run[kname] = t / n_calls[kname] / 1e3
        each = ", ".join(f"{c} x {n[:60]} {tn / c / 1e3:.5f} ms"
                         for n, (tn, c) in hits.items())
        log(phase, f"in the main path: {n_calls[kname]} {kname} calls "
            f"({each}), {in_run[kname]:.5f} ms device time a call")
    return in_run


def tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, dev) for v in tree]
    return tree.to(dev)


@contextlib.contextmanager
def recording(M, force=None):
    """Within the block, every ``prefill`` and ``decode_step`` appends
    (kind, input tokens, f32 logits on the CPU) to the yielded list, in
    call order.  With ``force`` (an earlier recording) each
    ``decode_step`` takes that run's input token instead of its own:
    teacher forcing."""
    calls = []
    orig_p, orig_d = M.prefill, M.decode_step

    def prefill(*args, **kw):
        logits, cache = orig_p(*args, **kw)
        calls.append(("prefill", None, logits.float().cpu()))
        return logits, cache

    def decode_step(params, cache, tokens, *args, **kw):
        if force is not None:
            kind, forced, _ = force[len(calls)]
            if kind != "decode_step":
                raise AssertionError("card and CPU runs called the model "
                                     "in another order")
            tokens = forced.to(tokens.device)
        logits, cache = orig_d(params, cache, tokens, *args, **kw)
        calls.append(("decode_step", tokens.cpu(), logits.float().cpu()))
        return logits, cache

    M.prefill, M.decode_step = prefill, decode_step
    try:
        yield calls
    finally:
        M.prefill, M.decode_step = orig_p, orig_d


def serve_card_vs_cpu(dev, path: str) -> None:
    """The tiny apps of serving path ``path`` through the same driver on
    the CPU and on the card, the card teacher-forced with the CPU's
    tokens; a prompt of 40 past the tiny window of 16 and 6 decode steps
    past the ring's wrap."""
    from repro_torch.models import model as M
    from repro_torch.serving import AppSpec
    cfgs = serve_archs(path, tiny=True)
    prompt_len, gen_len = SERVE_TINY_SHAPE
    cpu_params = [model_params(c, torch.device("cpu"), i)
                  for i, c in enumerate(cfgs)]
    wl = serve_workload(5, seed=1)
    runs = {}
    for where, params in (("cpu", cpu_params),
                          ("card", [tree_to(p, dev) for p in cpu_params])):
        apps = [AppSpec(c.name, gen_len=gen_len, arch=c, params=p,
                        prompt_len=prompt_len) for c, p in zip(cfgs, params)]
        run = serve_driver(path, apps, torch.device("cpu") if where == "cpu"
                           else dev)
        with recording(M, force=runs.get("cpu")) as calls:
            run(wl)
        runs[where] = calls
    if len(runs["card"]) != len(runs["cpu"]):
        raise AssertionError("card and CPU ran different numbers of steps")
    err, compared = 0.0, 0
    for i, ((kind, _, want), (_, _, got)) in enumerate(zip(runs["cpu"],
                                                          runs["card"])):
        err = max(err, check_close(f"tiny serving {kind} {i}", got, want,
                                   1e-4, 1e-4))
        top2 = torch.topk(want[0, -1], 2).values
        if float(top2[0] - top2[1]) > 1e-3:
            compared += 1
            if int(got[0, -1].argmax()) != int(want[0, -1].argmax()):
                raise AssertionError(f"tiny serving {kind} {i}: greedy "
                                     "token differs")
    log("5 card=cpu", f"{path}: tiny {' + '.join(c.name for c in cfgs)} "
        f"serving, 5 requests, {len(runs['cpu'])} model calls "
        f"teacher-forced: every "
        f"logit within 1e-4 of the CPU's (max abs err {err:.3g}), greedy "
        f"tokens equal at all {compared} steps with a top-2 margin > 1e-3")


def model_timings(mods, launches, captured, errs, in_run) -> list:
    """One kernels-JSON row per model kernel; ``launches``, ``captured``
    and ``in_run`` map each serving path run to its counts, captured
    inputs and in-run device times.  Every captured call is timed and
    logged (and listed in the row's ``calls``); the row's times are
    those of the call with the most work."""
    rows = []
    for name in MODEL_KERNELS:
        mod = mods[name]
        kernel, plain = getattr(mod, name), getattr(mod, name + "_ref")
        results = []
        for path in captured:
            for call, args, kw in captured[path][name]:
                saved = dict(mod.launches)
                sets = cold_sets(args)
                lib = library_call(name, args, kw)
                res = {"path": path, "call": call,
                       "shape": [list(a.shape) for a in args], "kw": kw,
                       "stream_ms": time_ms(kernel, sets, kw),
                       "ms": device_ms(kernel, sets, kw),
                       "plain_ms": device_ms(plain, sets, kw),
                       "library_ms": None if lib is None
                       else device_ms(lib, sets, kw)}
                del sets
                mod.launches.update(saved)
                if res["ms"] <= 0.0 or res["plain_ms"] <= 0.0:
                    raise AssertionError(f"{name}: the profiler saw no "
                                         "device time")
                res["bound_ms"], res["bound_by"], moved, ops = model_bound(
                    name, args, kw)
                shape = ", ".join("x".join(map(str, a.shape)) for a in args)
                lib_s = "n/a" if res["library_ms"] is None \
                    else f"{res['library_ms']:.5f} ms"
                log("6 timings", f"{name} at the {path} path's {shape} {kw} "
                    f"(call {call}), inputs cold in L2: device time per call "
                    f"(profiler) kernel {res['ms']:.5f} ms, plain "
                    f"{res['plain_ms']:.5f} ms, library {lib_s}; stream "
                    f"time kernel {res['stream_ms']:.5f} ms; bound "
                    f"{res['bound_ms']:.5f} ms by {res['bound_by']} "
                    f"({moved} bytes, {ops} operations); {gpu_line()}")
                results.append((ops, res))
        if not results:
            if any(n[name] for n in launches.values()):
                raise AssertionError(f"no captured main-path input for "
                                     f"{name}")
            continue        # a short call whose paths do not run it
        res = max(results, key=lambda r: r[0])[1]
        rows.append({"name": name, "route": "cuda",
                     "source": MODEL_SOURCE.format(name),
                     "replaces": REPLACES[name],
                     "launches": sum(n[name] for n in launches.values()),
                     **{f"launches_{p}": n[name]
                        for p, n in launches.items()},
                     "max_abs_err": errs[name],
                     "ms": res["ms"], "plain_ms": res["plain_ms"],
                     "bound_ms": res["bound_ms"],
                     "bound_by": res["bound_by"],
                     "library_ms": res["library_ms"],
                     "stream_ms": res["stream_ms"],
                     **{f"in_run_ms_{p}": t[name]
                        for p, t in in_run.items() if name in t},
                     "calls": [r for _, r in results]})
    return rows


# ---------------------------------------------------------------------------
# the train path
# ---------------------------------------------------------------------------
TRAIN = "train"
TRAIN_ARCH = "qwen2-1.5b"
TRAIN_SHAPE = "train_4k"      # its sequence length; its batch cut to 8
TRAIN_BATCH, TRAIN_MICRO = 8, 4
TRAIN_STEPS, TRAIN_WARMUP = 4, 2
TRAIN_TINY = (64, 8)          # sequence, batch of --train-tiny
BWD = "flash_attention_bwd"
BWD_SOURCE = "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"
# no Pallas backward: the JAX package trains through the XLA
# flash_chunked and takes its gradient with jax.vjp
BWD_REPLACES = "src/repro/models/attention.py:117"
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def bwd_cases(dev):
    """(label, q, k, v, do, kw) cases of the backward kernels: the train
    path's causal 24 x 4096 x 128 (B = 2 x 12 heads) in bf16 and f32,
    causal with window 1024 and softcap 50 at hd 256, the same with
    softcap 5 and q scaled by 4 (logits of std 4 far into tanh's curve,
    where a kernel without the 1 - tanh^2 factor misses both tolerances
    by some 100x; at softcap 50 and std 1 it would pass in bf16),
    non-causal with Sq = Sk and Sq < Sk, head widths 64 and 96, S = 1000
    (not a tile multiple), rows with no visible key, and rows that are no
    16-byte multiple (the kernels' one-value loads)."""
    g = torch.Generator(device="cpu").manual_seed(5)
    cases = []
    for dtype, bh, sq, sk, hd, kw, what, scale in (
            (torch.bfloat16, 24, 4096, 4096, 128, {"causal": True},
             "train path's causal shape", 1.0),
            (torch.float32, 24, 4096, 4096, 128, {"causal": True},
             "train path's causal shape", 1.0),
            (torch.float32, 8, 2048, 2048, 256,
             {"causal": True, "window": 1024, "softcap": 50.0},
             "window 1024, softcap 50, hd 256", 1.0),
            (torch.bfloat16, 8, 2048, 2048, 256,
             {"causal": True, "window": 1024, "softcap": 50.0},
             "window 1024, softcap 50, hd 256", 1.0),
            (torch.float32, 8, 2048, 2048, 256,
             {"causal": True, "window": 1024, "softcap": 5.0},
             "window 1024, softcap 5 on logits of std 4, hd 256", 4.0),
            (torch.bfloat16, 8, 2048, 2048, 256,
             {"causal": True, "window": 1024, "softcap": 5.0},
             "window 1024, softcap 5 on logits of std 4, hd 256", 4.0),
            (torch.float32, 8, 1024, 1024, 64, {"causal": False},
             "non-causal Sq = Sk, hd 64", 1.0),
            (torch.float32, 8, 512, 1024, 64, {"causal": False},
             "non-causal Sq < Sk, hd 64", 1.0),
            (torch.float32, 8, 1024, 1024, 64, {"causal": True},
             "causal hd 64", 1.0),
            (torch.float32, 8, 1024, 1024, 96, {"causal": True},
             "causal hd 96", 1.0),
            (torch.bfloat16, 8, 1024, 1024, 96, {"causal": True},
             "causal hd 96", 1.0),
            (torch.float32, 4, 1000, 1000, 128, {"causal": True},
             "S = 1000", 1.0),
            (torch.float32, 4, 300, 300, 96, {"causal": False,
                                              "window": 40},
             "non-causal window 40, hd 96", 1.0),
            (torch.float32, 2, 96, 32, 64, {"causal": True, "window": 16},
             "rows with no visible key", 1.0),
            (torch.float32, 2, 50, 70, 37, {"causal": True},
             "hd 37: rows not 16-byte multiples", 1.0),
            (torch.bfloat16, 2, 130, 130, 100, {"causal": True},
             "hd 100: bf16 rows not 16-byte multiples", 1.0)):
        dn = "f32" if dtype == torch.float32 else "bf16"
        q, k, v, do = (torch.randn(s, generator=g).to(dev, dtype)
                       for s in ((bh, sq, hd), (bh, sk, hd), (bh, sk, hd),
                                 (bh, sq, hd)))
        cases.append((f"{dn} {what} {bh}x{sq}x{sk}x{hd}", q * scale, k, v,
                      do, kw))
    return cases


def kernel_forward(FA, q, k, v, kw):
    """``flash_attention`` under grad on the card, the training route
    (``FlashAttention``): -> (out, the kernel's o and lse as its backward
    reads them)."""
    with torch.enable_grad():
        out = FA.flash_attention(*(x.detach().requires_grad_(True)
                                   for x in (q, k, v)), **kw)
    *_, o, lse = out.grad_fn.saved_tensors
    return out, o.detach(), lse


def check_bwd_call(FA, label, q, k, v, do, kw, o=None, lse=None) -> float:
    """The forward of the training route bitwise the serving forward
    (when no ``o`` is given; its ``o`` and ``lse`` are then used), the
    backward launched twice with bitwise-equal results and within
    ``BWD_TOL`` of the largest plain gradient of each of dq, dk, dv, the
    plain twin fed the same ``o`` and ``lse``; returns the largest
    absolute difference."""
    if o is None:
        _, o, lse = kernel_forward(FA, q, k, v, kw)
        with torch.no_grad():
            plain_fwd = FA.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        if not torch.equal(raw_bits(o), raw_bits(plain_fwd)):
            raise AssertionError(f"flash_attention {label}: the output with "
                                 "lse differs from the output without")
    got = FA.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    again = FA.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    want = FA.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    err = 0.0
    for name, a, b, w in zip(("dq", "dk", "dv"), got, again, want):
        if not torch.equal(raw_bits(a), raw_bits(b)):
            raise AssertionError(f"{BWD} {label}: two launches on the same "
                                 f"inputs give different {name}")
        if a.dtype != q.dtype or not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{BWD} {label}: {name} is {a.dtype} or "
                                 "not finite")
        e = float((a.float() - w.float()).abs().max())
        top = float(w.float().abs().max())
        if not e <= BWD_TOL[q.dtype] * top:
            raise AssertionError(f"{BWD} {label}: {name} max abs err {e:.3g}"
                                 f" > {BWD_TOL[q.dtype]} x {top:.3g}")
        err = max(err, e)
    return err


def check_flash_backward(FA, GMM, dev) -> float:
    """Phase 3 for the training kernels: every ``bwd_cases`` case, and
    the autograd route: a flash call under grad on the card has a
    ``grad_fn`` whose backward launches the kernels, and the grouped
    matmul refuses grad there (it has no backward yet)."""
    err = 0.0
    for label, q, k, v, do, kw in bwd_cases(dev):
        e = check_bwd_call(FA, label, q, k, v, do, kw)
        err = max(err, e)
        log("3 kernels", f"{BWD} {label} {kw}: lse leaves the forward's "
            f"output bitwise; dq, dk, dv within {BWD_TOL[q.dtype]} of the "
            f"plain gradients' largest (max abs err {e:.3g}), bitwise "
            "equal over two launches")
    q, k, v = (torch.randn(2, 64, 32, device=dev, requires_grad=True)
               for _ in range(3))
    before = FA.launches[BWD]
    out = FA.flash_attention(q, k, v)
    if out.grad_fn is None:
        raise AssertionError("flash_attention under grad on the card "
                             "returned an output without grad_fn")
    out.sum().backward()
    if FA.launches[BWD] != before + 1 or any(
            x.grad is None or not bool(x.grad.abs().sum() > 0)
            for x in (q, k, v)):
        raise AssertionError("flash_attention's backward on the card did "
                             "not launch the kernels or gave no gradient")
    lhs = torch.randn(2, 8, 16, device=dev, requires_grad=True)
    sizes = torch.tensor([8, 3], dtype=torch.int32, device=dev)
    try:
        GMM.grouped_matmul(lhs, torch.randn(2, 16, 8, device=dev), sizes)
    except NotImplementedError:
        pass
    else:
        raise AssertionError("grouped_matmul accepted grad on the card")
    log("3 kernels", "flash_attention under grad on the card: output with "
        "a grad_fn whose backward launched the backward kernels; "
        "grouped_matmul under grad on the card raises (no backward yet)")
    return err


def noise_zero_leaves(params, master, gen) -> int:
    """Seeded noise of scale ``ZERO_LEAF_NOISE`` on every all-zero leaf
    of the f32 master (biases, norm offsets), copied to the compute
    params: the ``live_params`` rule on a training state.  -> the number
    of leaves noised."""
    from repro_torch.optim.adamw import tree_leaves
    n = 0
    for p, m in zip(tree_leaves(params), tree_leaves(master)):
        if not bool(m.any()):
            m.copy_(ZERO_LEAF_NOISE * torch.randn(m.shape, generator=gen,
                                                  device=m.device))
            p.copy_(m.to(p.dtype))
            n += 1
    return n


def train_implied(cfg, micro: int, steps: int) -> dict:
    """Flash launches the shapes imply: one forward per attention layer
    of each microbatch, twice under remat (the forward and its
    recomputation in the backward), one backward; for the steps and for
    the gradient check of one microbatch before them."""
    n = sum(k not in ("rec", "mlstm", "slstm") for k in cfg.kinds())
    return {"flash_attention": n * micro * steps * 2 + n * 2,
            BWD: n * micro * steps + n}


def run_train(FA, dev, tiny: bool):
    """Drive the train path once: qwen2-1.5b as published (28 layers, d
    1536, 12/2 heads, d_ff 8960, vocab 151936), bf16 compute with the f32
    master, remat on, random weights from seed 0 (zero leaves noised),
    the port's synthetic ``TokenStream`` at ``train_4k``'s 4096 tokens,
    8 sequences a step in 4 microbatches of 2, ``AdamWConfig()`` with
    warmup 2; first one ``loss_fn`` gradient of one microbatch (every
    leaf finite and nonzero), then 4 steps of ``build_train_step``, then
    one profiled step.  -> (launches, captured inputs, in-run device ms
    per call)."""
    from repro_torch.configs.base import SHAPES, get_arch
    from repro_torch.data import DataConfig, TokenStream
    from repro_torch.launch import train as T
    from repro_torch.models import model as M
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.adamw import tree_leaves, tree_map
    from torch.profiler import ProfilerActivity, profile
    phase = f"4 {TRAIN}"
    cfg = get_arch(TRAIN_ARCH)
    seq, batch = SHAPES[TRAIN_SHAPE].seq_len, TRAIN_BATCH
    if tiny:
        cfg = cfg.tiny()
        seq, batch = TRAIN_TINY
    mopts = M.ModelOptions(dtype=torch.bfloat16, remat=True)
    t0 = time.perf_counter()
    params, opt = T.init_train_state(cfg, mopts, dev, seed=0)
    noised = noise_zero_leaves(params, opt.master,
                               torch.Generator(dev).manual_seed(1))
    torch.cuda.synchronize()
    log(phase, f"{cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
        f"heads {cfg.n_heads}/{cfg.n_kv_heads} x {cfg.hd}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab_size}: {n_params(params) / 1e9:.3f} B parameters "
        f"in bf16 with an f32 master and moments, {noised} zero leaves "
        f"noised; drawn in {time.perf_counter() - t0:.2f} s")
    log(phase, f"sequence {seq} ({TRAIN_SHAPE}'s), {batch} sequences a "
        f"step in {TRAIN_MICRO} microbatches of {batch // TRAIN_MICRO} "
        f"(cut from {TRAIN_SHAPE}'s {SHAPES[TRAIN_SHAPE].global_batch}), "
        f"{TRAIN_STEPS} steps, warmup {TRAIN_WARMUP}, remat on")
    stream = TokenStream(DataConfig(cfg.vocab_size, seq, batch, seed=0))
    batches = [stream.batch_at(i) for i in range(TRAIN_STEPS + 1)]
    FA.reset_launches()

    # the gradient check, one microbatch
    with kernel_capture([(FA, "flash_attention"), (FA, BWD)]) as captured:
        tree = tree_map(lambda x: x.detach().requires_grad_(True), params)
        mb = T.batch_to({k: v[0::TRAIN_MICRO] for k, v in batches[0].items()},
                        dev)
        loss, _ = M.loss_fn(tree, mb, cfg, mopts)
        grads = torch.autograd.grad(loss, tree_leaves(tree))
        loss = loss.detach()
    bad = [i for i, g in enumerate(grads)
           if not bool(torch.isfinite(g).all()) or not bool(g.abs().max() > 0)]
    if bad or not bool(torch.isfinite(loss)):
        raise AssertionError(f"gradient check: loss {float(loss)}, leaves "
                             f"{bad} of {len(grads)} not finite or all 0")
    check = dict(FA.launches)
    want = train_implied(cfg, TRAIN_MICRO, 0)
    log(phase, f"gradient check: loss {float(loss):.5f} on one microbatch; "
        f"all {len(grads)} parameter leaves finite and nonzero; flash "
        f"launches {json.dumps(check)}, implied {json.dumps(want)}")
    if {k: check[k] for k in want} != want:
        raise AssertionError(f"gradient check launches {check} != {want}")
    del tree, grads, loss, mb

    step = T.build_train_step(cfg, mopts, AdamWConfig(),
                              T.TrainStepConfig(microbatches=TRAIN_MICRO,
                                                compute_dtype=torch.bfloat16,
                                                warmup_steps=TRAIN_WARMUP),
                              dev)
    losses = []
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params, opt, mets = step(params, opt, batches[i])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        m = {k: float(v) for k, v in mets.items()}
        losses.append(m["loss"])
        log(phase, f"step {i}: loss {m['loss']:.5f}, ce {m['ce']:.5f}, "
            f"lr_scale {m['lr_scale']:.3f}, grad_norm {m['grad_norm']:.5f}, "
            f"update_skipped {int(m['update_skipped'])}; {dt:.3f} s "
            f"(synchronised), {batch * seq / dt:.1f} tokens/s, peak device "
            f"memory {peak:.2f} GiB; {gpu_line()}")
        if not np.isfinite(m["loss"]) or int(m["update_skipped"]):
            raise AssertionError(f"step {i}: loss {m['loss']}, update "
                                 f"skipped {m['update_skipped']}")
    launches = {k: FA.launches[k] for k in ("flash_attention", BWD)}
    want = train_implied(cfg, TRAIN_MICRO, TRAIN_STEPS)
    log(phase, f"kernel launches {json.dumps(launches)}, implied by the "
        f"shapes {json.dumps(want)} (remat: the forward twice a "
        "microbatch)")
    if launches != want:
        raise AssertionError(f"launches {launches} != implied {want}")

    # one more step under the profiler: busy/idle share, top device ops
    saved = dict(FA.launches)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt, mets = step(params, opt, batches[TRAIN_STEPS])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    calls = {k: FA.launches[k] - saved[k] for k in saved}
    FA.launches.update(saved)
    spans = device_activity(prof)
    busy = busy_us(spans) / 1e6
    log(f"{phase} profile", f"one step (step {TRAIN_STEPS}, loss "
        f"{float(mets['loss']):.5f}): wall {wall:.3f} s, device busy "
        f"{busy:.3f} s ({100 * busy / wall:.1f}%, idle "
        f"{100 * (1 - busy / wall):.1f}%), {len(spans)} device activities; "
        f"{gpu_line()}")
    by_name: dict = {}
    for name, s0, e in spans:
        tot, cnt = by_name.get(name, (0.0, 0))
        by_name[name] = (tot + e - s0, cnt + 1)
    for name, (tot, cnt) in sorted(by_name.items(),
                                   key=lambda kv: -kv[1][0])[:12]:
        log(f"{phase} profile", f"{tot / 1e3:10.2f} ms {cnt:7d} x  "
            f"{name[:90]}")
    in_run = {}
    for kname, marks in (("flash_attention", ("flash_attention_kernel",)),
                         (BWD, ("flash_bwd_",))):
        t = sum(tot for n, (tot, _) in by_name.items()
                if any(mk in n for mk in marks))
        if calls[kname]:
            in_run[kname] = t / calls[kname] / 1e3
            log(f"{phase} profile", f"in the main path: {calls[kname]} "
                f"{kname} calls, {in_run[kname]:.4f} ms device time a call")
    del params, opt, batches
    return launches, captured, in_run


def train_timings(FA, launches, captured, err, in_run) -> dict:
    """The backward's kernels-JSON row: at the train path's captured
    shape, device time (profiler) of the kernel, of its plain twin and of
    autograd through ``sdpa`` (SDPA's fused kernel: FlashAttention-2's
    backward in bf16, the memory-efficient one in f32; its backward
    only, the forward run beforehand; for comparison, never in the
    port), in bf16 as captured and again on f32 copies, beside the
    operations bound."""
    from repro_torch.kernels.flash_attention import visible_mask
    (_, (q, k, v, o, lse, do), kw), = captured[BWD]
    row = {"name": BWD, "route": "cuda", "source": BWD_SOURCE,
           "replaces": BWD_REPLACES, "launches": launches[BWD],
           "max_abs_err": err}
    for dtype in (torch.bfloat16, torch.float32):
        saved = dict(FA.launches)
        args = [x.to(dtype) for x in (q, k, v)]
        if dtype != q.dtype:
            _, o32, lse32 = kernel_forward(FA, *args, kw)
            args += [o32, lse32, do.to(dtype)]
        else:
            args += [o, lse, do]
        sets = cold_sets(args)
        ms = device_ms(FA.flash_attention_bwd, sets, kw)
        stream_ms = time_ms(FA.flash_attention_bwd, sets, kw)
        plain_ms = device_ms(FA.flash_attention_bwd_ref, sets, kw)
        del sets
        library_ms = None
        if library_call("flash_attention", args, kw) is not None:
            lib_sets = []
            for _ in range(4):
                qq, kk, vv = (x.clone().requires_grad_(True)
                              for x in args[:3])
                out = sdpa(qq, kk, vv, kw.get("causal", True))
                lib_sets.append((out, qq, kk, vv, args[5].clone()))
            library_ms = device_ms(
                lambda out, qq, kk, vv, g: torch.autograd.grad(
                    out, (qq, kk, vv), g, retain_graph=True), lib_sets, {})
            del lib_sets
        FA.launches.update(saved)
        bh, sq, hd = args[0].shape
        pairs = int(visible_mask(sq, args[1].shape[1],
                                 causal=kw.get("causal", True),
                                 window=kw.get("window", 0),
                                 device=args[0].device).sum())
        ops = 10 * bh * hd * pairs
        moved = 8 * nbytes(args[0]) + nbytes(args[4])
        rate = BF16_OPS_PER_S if dtype == torch.bfloat16 \
            else TF32X3_OPS_PER_S
        by_ops, by_bytes = ops / rate * 1e3, moved / HBM_BYTES_PER_S * 1e3
        bound = max(by_ops, by_bytes)
        bound_by = "operations" if by_ops >= by_bytes else "bytes"
        dn = "bf16" if dtype == torch.bfloat16 else "f32"
        lib_s = "n/a" if library_ms is None else f"{library_ms:.4f} ms"
        log("6 timings", f"{BWD} {dn} at the train path's "
            f"{'x'.join(map(str, args[0].shape))} {kw}, inputs cold in L2: "
            f"device time per call (profiler) kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, library (autograd through SDPA, its "
            f"backward) {lib_s}; stream time kernel {stream_ms:.4f} ms; "
            f"bound {bound:.4f} ms by {bound_by} ({moved} bytes, {ops} "
            f"operations, {ops / ms / 1e9:.2f} TFLOP/s achieved); "
            f"{gpu_line()}")
        if ms <= 0.0 or plain_ms <= 0.0:
            raise AssertionError(f"{BWD}: the profiler saw no device time")
        if dtype == torch.bfloat16:
            row.update(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                       bound_by=bound_by, library_ms=library_ms,
                       stream_ms=stream_ms)
        else:
            row.update(ms_f32=ms, plain_ms_f32=plain_ms, bound_ms_f32=bound,
                       library_ms_f32=library_ms, stream_ms_f32=stream_ms)
    if BWD in in_run:
        row["in_run_ms_train"] = in_run[BWD]
    row["shape"] = [list(x.shape) for x in (q, k, v)]
    row["kw"] = kw
    return row


def train_card_vs_cpu(dev) -> None:
    """Tiny qwen2-1.5b in f32 with its zero leaves noised, one batch of 4
    sequences of 64 tokens in one microbatch: the card's loss and every
    gradient against the CPU port's (loss 1e-5 relative, each leaf 1e-4
    of its largest magnitude), then ``adamw_update`` on the card fed the
    CPU's gradients against the CPU's update at rtol 1e-6 (the master
    and params with a floor of 1e-6 of the leaf's largest magnitude: an
    entry that the update nearly cancels keeps only its rounding)."""
    from repro_torch.configs.base import get_arch
    from repro_torch.data import DataConfig, TokenStream
    from repro_torch.launch import train as T
    from repro_torch.models import model as M
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
    from repro_torch.optim.adamw import tree_leaves, tree_map
    cfg = get_arch(TRAIN_ARCH).tiny()
    opt = M.ModelOptions(dtype=torch.float32, remat=True)
    cpu = torch.device("cpu")
    cpu_params = model_params(cfg, cpu, 0)
    batch = TokenStream(DataConfig(cfg.vocab_size, 64, 4, seed=0)).batch_at(0)
    out = {}
    for where, d in (("cpu", cpu), ("card", dev)):
        tree = tree_map(lambda x: x.detach().to(d).requires_grad_(True),
                        cpu_params)
        loss, _ = M.loss_fn(tree, T.batch_to(batch, d), cfg, opt)
        grads = torch.autograd.grad(loss, tree_leaves(tree))
        out[where] = (float(loss.detach()), [g.cpu() for g in grads])
    (lc, gc), (lg, gg) = out["cpu"], out["card"]
    if not abs(lg - lc) <= 1e-5 * abs(lc):
        raise AssertionError(f"tiny train: card loss {lg} != CPU loss {lc}")
    worst = 0.0
    for i, (a, b) in enumerate(zip(gg, gc)):
        e, top = float((a - b).abs().max()), float(b.abs().max())
        if not (e <= 1e-4 * top and top > 0):
            raise AssertionError(f"tiny train: gradient leaf {i} max abs err "
                                 f"{e:.3g} > 1e-4 x {top:.3g}")
        worst = max(worst, e / top)
    it = iter(gc)
    grads_tree = tree_map(lambda _: next(it), cpu_params)
    res = {}
    for where, d in (("cpu", cpu), ("card", dev)):
        p = tree_to(cpu_params, d)
        res[where] = adamw_update(tree_to(grads_tree, d), adamw_init(p),
                                  AdamWConfig(), 1.0,
                                  compute_dtype=torch.float32)
    (pc, oc, mc), (pg, og, mg) = res["cpu"], res["card"]
    for name, tg, tc, floor in (("params", pg, pc, 1e-6),
                                ("master", og.master, oc.master, 1e-6),
                                ("m", og.m, oc.m, 0.0),
                                ("v", og.v, oc.v, 0.0)):
        for a, b in zip(tree_leaves(tg), tree_leaves(tc)):
            a = a.cpu()
            if not torch.allclose(a, b, rtol=1e-6,
                                  atol=floor * float(b.abs().max())):
                raise AssertionError(f"tiny train: adamw_update's {name} on "
                                     "the card differs from the CPU's")
    if int(og.step) != int(oc.step) or int(mg["update_skipped"]):
        raise AssertionError("tiny train: adamw_update's step differs")
    log("5 card=cpu", f"{TRAIN}: tiny {cfg.name} f32, 4 x 64 tokens, remat: "
        f"loss {lg:.7f} on the card, {lc:.7f} on the CPU; all {len(gg)} "
        f"gradient leaves within 1e-4 of their largest (worst "
        f"{worst:.3g}); adamw_update on the card fed the CPU's gradients "
        f"equal to the CPU's at rtol 1e-6 (grad_norm "
        f"{float(mg['grad_norm']):.6f} / {float(mc['grad_norm']):.6f})")


def card_vs_cpu_phase(X, E, K, P, dev, sweeps, paths) -> None:
    """Phase 5: every card-vs-CPU comparison of the paths driven."""
    for path in sweeps:
        if path == "stream":
            stream_card_vs_cpu(X, E, dev)
        elif path == "chunked":
            chunked_card_vs_cpu(X, E, dev)
        elif path == "learned":
            learned_card_vs_cpu(X, E, dev)
        elif path == "es":
            es_card_vs_cpu(dev)
        else:
            card_vs_cpu(X, E, dev, path)
    if "traced" in sweeps:
        for path in ("flat", "workflow"):
            card_vs_cpu(X, E, dev, path, traced=True)
        user_policy_on_card(X, E, K, P, dev)
    for path in SERVE_PATHS:
        if path in paths:
            serve_card_vs_cpu(dev, path)
    if TRAIN in paths:
        train_card_vs_cpu(dev)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--replicas", type=int, default=4096,
                    help="replicas of the scenario path")
    ap.add_argument("--flat-replicas", type=int, default=4096,
                    help="replicas of the flat path")
    ap.add_argument("--workflow-replicas", type=int, default=4096,
                    help="replicas of the workflow path")
    ap.add_argument("--k8-replicas", type=int, default=4096,
                    help="replicas of the flat path at K = 8")
    ap.add_argument("--traced-replicas", type=int, default=4096,
                    help="replicas of the traced path")
    ap.add_argument("--stream-replicas", type=int, default=4096,
                    help="replicas of the stream path")
    ap.add_argument("--chunked-replicas", type=int, default=8192,
                    help="replicas of the chunked path")
    ap.add_argument("--chunk", type=int, default=4096,
                    help="the chunked path's chunk size")
    ap.add_argument("--learned-replicas", type=int, default=4096,
                    help="replicas of the learned path")
    ap.add_argument("--es-generations", type=int, default=ES_GENERATIONS,
                    help="ES generations of the es path")
    ap.add_argument("--tasks", type=int, default=512,
                    help="tasks a replica of the sweep paths (the stream "
                    "path takes STREAM_TASKS)")
    ap.add_argument("--machines", type=int, default=32)
    ap.add_argument("--paths", default=",".join(ALL_PATHS),
                    help="comma-separated main paths to drive (a short "
                    "call may drive fewer; the full check drives all)")
    ap.add_argument("--serve-tiny", action="store_true",
                    help="serve the apps' tiny configurations (prompt 40, "
                    "6 tokens) instead of the full-width ones")
    ap.add_argument("--train-tiny", action="store_true",
                    help="train tiny qwen2-1.5b (8 sequences of 64 "
                    "tokens) instead of the full-width model")
    a = ap.parse_args()
    paths = [p for p in a.paths.split(",") if p]
    if not set(paths) <= set(ALL_PATHS):
        ap.error(f"--paths takes {ALL_PATHS}")
    sweeps = [p for p in PATHS if p in paths]
    width = {"flat": a.flat_replicas, "scenario": a.replicas,
             "workflow": a.workflow_replicas, "flat_k8": a.k8_replicas,
             "traced": a.traced_replicas, "stream": a.stream_replicas,
             "chunked": a.chunked_replicas, "learned": a.learned_replicas}
    tasks = {p: STREAM_TASKS if p == "stream" else a.tasks for p in PATHS}
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs a GPU",
              file=sys.stderr)
        return 2
    # products outside the kernels (projections, MLPs, unembedding) stay
    # in full f32, which the model tolerances assume
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import grouped_matmul as GMM
    mods = {"flash_attention": FA, "grouped_matmul": GMM}

    t_all = time.perf_counter()
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    log("1 device", f"{name} x{torch.cuda.device_count()}; torch "
        f"{torch.__version__} cuda {torch.version.cuda}; TF32 off for "
        f"matmul and cuDNN")
    print(gpu_line(), flush=True)

    t0 = time.perf_counter()
    build.build_all()
    log("2 build", f"{len(build.LIBRARIES)} libraries, one nvcc each in "
        f"parallel, {time.perf_counter() - t0:.1f} s")
    for lib, meta in build.info.items():
        log("2 build", f"{os.path.basename(meta['library'])} in "
            f"{meta['seconds']:.1f} s "
            f"({' '.join(build.LIBRARIES[lib]['flags'])})")
        for line in meta.get("log", "").splitlines():
            if "registers" in line or "spill" in line or "entry" in line:
                print("    " + line.strip())

    return run_phases(a, paths, sweeps, width, tasks, mods, dev, name,
                      t_all)


def run_phases(a, paths, sweeps, width, tasks, mods, dev, name,
               t_all) -> int:
    """Phases 3 to 6 of a call."""
    from repro_torch.core import engine as E
    from repro_torch.core import schedulers as P
    from repro_torch.core import state as S
    from repro_torch.core import streaming as ST
    from repro_torch.kernels import build
    from repro_torch.kernels import fma as FMA
    from repro_torch.kernels import ref as KREF
    from repro_torch.kernels import sched_argmin as K
    from repro_torch.launch import experiment as X
    errs = check_kernels(K, KREF, dev)
    errs["fma"] = check_fma(FMA, KREF, dev)
    errs.update(check_model_kernels(mods, dev))
    errs[BWD] = check_flash_backward(mods["flash_attention"],
                                     mods["grouped_matmul"], dev)
    launches, captured, peaks = {}, {}, {}
    flat_run = scenario_run = flat_cols = None
    for path in sweeps:
        if path == "es":
            launches[path], captured[path], _, peaks[path] = run_es(
                E, K, dev, a.es_generations)
            torch.cuda.empty_cache()
            recheck_captured(K, KREF, captured[path], path)
            continue
        if path == "chunked":
            res, launches[path], captured[path], stats, wall, peaks[path] \
                = run_chunked(X, E, K, P, dev, width[path], a.chunk,
                              a.tasks, a.machines, flat_cols)
        else:
            res, launches[path], captured[path], stats, wall, \
                peaks[path] = run_main(X, E, K, S, ST, P, dev, path,
                                       width[path], tasks[path], a.machines)
        if path == "flat" and "chunked" in sweeps:
            flat_cols = ({k: v.cpu() for k, v in res.metrics.items()},
                         wall, peaks[path])
        if path == "flat" and "flat_k8" in sweeps \
                and width["flat"] == width["flat_k8"]:
            flat_run = (fields(res.state), stats, wall)
        if path == "scenario" and "traced" in sweeps \
                and width["scenario"] == width["traced"]:
            scenario_run = (fields(res.state), stats, wall)
        if path == "flat_k8":
            check_k8(X, E, dev, res, stats, wall, flat_run, a.tasks,
                     a.machines)
            flat_run = None
        if path == "traced":
            check_traced(X, E, S, dev, res, stats, wall, scenario_run,
                         a.tasks, a.machines)
            scenario_run = None
        del res
        torch.cuda.empty_cache()
        recheck_captured(K, KREF, captured[path], path)
    if "stream" in peaks:
        log("4 stream", f"the path's own peak device memory "
            f"{peaks['stream']:.2f} GiB, the flat path's "
            f"{peaks.get('flat', float('nan')):.2f} GiB; {gpu_line()}")
    rows = []
    serve_launches, serve_captured, in_run = {}, {}, {}
    for path in SERVE_PATHS:
        if path not in paths:
            continue
        # the path's weights are drawn after the previous path's are freed
        t0 = time.perf_counter()
        apps, serve_launches[path], serve_captured[path] = run_serve(
            mods, dev, path, a.serve_tiny)
        for kname, err in recheck_model_captured(
                mods, serve_captured[path], path).items():
            errs[kname] = max(errs[kname], err)
        in_run[path] = profile_serve(mods, apps, dev, path)
        del apps
        torch.cuda.empty_cache()
        log(f"4 {path}", f"the path's run, re-checks and profiled windows "
            f"took {time.perf_counter() - t0:.1f} s")
    train_row = None
    if TRAIN in paths:
        FA = mods["flash_attention"]
        t0 = time.perf_counter()
        t_launches, t_captured, t_in_run = run_train(FA, dev, a.train_tiny)
        (_, (q, k, v), kw), = t_captured["flash_attention"]
        shape = "x".join(map(str, q.shape))
        err = check_model_call(mods, "flash_attention", (q, k, v), kw,
                               f"{TRAIN} call 1 ({shape})")
        errs["flash_attention"] = max(errs["flash_attention"], err)
        log("3 kernels", f"flash_attention captured at the {TRAIN} path's "
            f"first call ({shape} {kw}): within tolerance, max abs err "
            f"{err:.3g}")
        (_, (bq, bk, bv, bo, blse, bdo), bkw), = t_captured[BWD]
        err = check_bwd_call(FA, f"{TRAIN} call 1 ({shape})", bq, bk, bv,
                             bdo, bkw, o=bo, lse=blse)
        errs[BWD] = max(errs[BWD], err)
        log("3 kernels", f"{BWD} captured at the {TRAIN} path's first call "
            f"({shape} {bkw}): within tolerance, max abs err {err:.3g}, "
            "bitwise equal over two launches")
        serve_launches[TRAIN] = {"flash_attention":
                                 t_launches["flash_attention"],
                                 "grouped_matmul": 0}
        serve_captured[TRAIN] = {"flash_attention":
                                 t_captured["flash_attention"],
                                 "grouped_matmul": []}
        if "flash_attention" in t_in_run:
            in_run[TRAIN] = {"flash_attention": t_in_run["flash_attention"]}
        train_row = (t_launches, t_captured, t_in_run)
        torch.cuda.empty_cache()
        log(f"4 {TRAIN}", f"the path's run, re-checks and profiled step "
            f"took {time.perf_counter() - t0:.1f} s")
    for path in sweeps:
        if path == "es":
            continue
        if path == "chunked":
            n_rep, chunk = CHUNKED_PROFILE
            profile_window(X, E, K, dev, path, n_rep, a.tasks, a.machines,
                           chunk=chunk)
        else:
            profile_window(X, E, K, dev, path, width[path], tasks[path],
                           a.machines, steps=WORKFLOW_PROFILE_STEPS
                           if path == "workflow" else 32)
    if sweeps:
        rows += timings(K, KREF, build, launches, captured, errs, sweeps)
    if set(sweeps) & set(FMA_PATHS):
        rows.append(fma_timings(FMA, KREF, launches, captured, errs["fma"],
                                sweeps))
    if serve_launches:
        rows += model_timings(mods, serve_launches, serve_captured, errs,
                              in_run)
    if train_row is not None:
        rows.append(train_timings(mods["flash_attention"], train_row[0],
                                  train_row[1], errs[BWD], train_row[2]))
    card_vs_cpu_phase(X, E, K, P, dev, sweeps, paths)
    log("done", f"{time.perf_counter() - t_all:.1f} s")
    print(gpu_line(), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
