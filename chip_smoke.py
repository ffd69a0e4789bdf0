#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) once on one NVIDIA GPU.

Run from anywhere, with no arguments, on a machine with a CUDA card, the
CUDA toolkit (``nvcc``) and PyTorch built for CUDA::

    python3 chip_smoke.py

Phases, one JSON line each; the first fault exits non-zero:

0. card      -- name and power limit (``nvidia-smi``), torch/CUDA versions.
1. build     -- every CUDA kernel compiled from ``src/repro_torch/kernels/csrc``.
2. kernels   -- each kernel against its plain PyTorch version on the card at
               the DeepSeek-v3 full-width shapes of one training step
               (4096 tokens), plus ragged and SMOKE shapes; error, median
               times (kernel, plain version, one PyTorch library call) and
               the least time the card could take (``bound_ms``).
3. forward   -- DeepSeek-v3 at published widths, depth cut to one dense and
               one MoE layer, b=1, s=4096, sigmoid router: ``Model.loss``
               with ``backend="cuda"`` against ``backend="reference"`` on
               the same weights.  This is the counted main-path run: the
               launch counters are reset before it and read after it, and
               must be exactly rmsnorm 8, flash 2, gmm 3.  A second
               reference run with fp32 attention scores shows how many
               tokens rounding alone routes to other experts.
4. train     -- DeepSeek-v3 at published widths, one dense layer (the
               training state of a full-width MoE layer, ~184 GB, cannot fit
               one 80 GB card), ``train`` for 3 steps, b=2, s=2048,
               n_micro=2, ``backend="cuda"``: finite losses, peak memory.
5. train_smoke -- one ``make_train_step`` on DeepSeek-v3 SMOKE (MLA + MoE,
               B=2, S=32, n_micro=2), ``backend="cuda"`` against
               ``backend="reference"`` from the same state: loss,
               grad_norm, m, v and the update of the master params.
6. the ``kernels`` summary line, then the ``ok`` line.

It imports nothing of JAX and nothing of the reference ``repro`` package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet,
# dense): the denominators of bound_ms.
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
FP32_FLOPS = 67e12

# Kernel against plain version: |got - want| <= ATOL + RTOL * |want|, the
# bf16 bound of the reference suite (tests/test_kernel_equivalence.py).
ATOL = RTOL = 5e-2
# Full-width forward, cuda against reference backend: relative loss gap,
# and logits max-diff under this share of the largest logit
# (tests/test_pallas_in_model.py's bound).
FWD_LOSS_RTOL = 1e-2
FWD_LOGIT_SHARE = 0.05
# ... over the tokens both runs route to the same experts and keep alike,
# which must be at least this share of the batch.  Rounding-level
# differences flip near-tied top-8 choices among 256 sigmoid scores for the
# rest: three H100 runs routed 3768 of 4096 tokens (92 %) alike.  The phase
# also routes a second reference run whose attention keeps fp32 scores, as
# a witness of how many tokens rounding alone flips: 3761 of 4096 alike
# with the bf16 reference, 3810 with the cuda run.
FWD_MIN_ALIKE = 0.85
# SMOKE train step, cuda against reference backend: loss and grad_norm
# relative gaps; m and v as a relative norm over all leaves; the share of
# elements whose update (master after - before) differs by more than lr/20;
# the share of tokens routed alike (FWD_MIN_ALIKE).  A first Adam step
# moves each weight by about lr·sign(g), so an element differs where its
# tiny gradient changes sign, or where a token routed to another expert
# moves that expert's gradient.  Two H100 runs read m 0.131, v 0.155, 3.03 %
# of the elements and 62 of 64 tokens routed alike; a reference run with
# fp32 attention scores, against the bf16 one, read 0.055, 0.052, 1.47 %
# and 63 of 64.  A fault in the update itself moves every element.
TRAIN_RTOL = 1e-2
TRAIN_MV_RTOL = 0.3
TRAIN_UPDATE_SHARE = 0.06

SEED = 0
KERNEL_ROWS = {
    "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:32"),
    "flash_attention": ("src/repro_torch/kernels/csrc/mla_attention.cu",
                        "src/repro/kernels/mla_attention.py:64"),
    "gmm": ("src/repro_torch/kernels/csrc/moe_gmm.cu",
            "src/repro/kernels/moe_gmm.py:34"),
}


def _emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def _fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def _check(cond: bool, msg: str) -> None:
    if not cond:
        _fail(msg)


# ---------------------------------------------------------------------------
# timing and comparison
# ---------------------------------------------------------------------------

def _time_ms(torch, fn, reps: int, rounds: int = 3) -> float:
    """Median over ``rounds`` of the mean device time of ``reps`` calls
    queued back to back between two CUDA events, after one warm-up call.
    Queued calls keep the host's launch cost out of the reading wherever
    the device work outlasts it; where it does not (a call of a few
    microseconds), the reading is the host's rate of launching."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def _compare(got, want):
    """(max abs err, max rel err where |want| >= 0.1, within tolerance)."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    ok = bool(((diff <= ATOL + RTOL * w.abs()) & g.isfinite()).all())
    big = w.abs() >= 0.1
    rel = float((diff[big] / w[big].abs()).max()) if bool(big.any()) else 0.0
    return float(diff.max()), rel, ok


def _rel_norm(torch, got, want) -> float:
    """||got - want|| / ||want|| over every leaf of two name -> tensor maps."""
    num = sum(float(torch.linalg.vector_norm(got[k].float() - want[k].float()))
              ** 2 for k in want)
    den = sum(float(torch.linalg.vector_norm(want[k].float())) ** 2
              for k in want)
    return (num / den) ** 0.5


def _bound_ms(n_bytes: float, flops: float, flop_rate: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_card(torch) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _emit("card", nvidia_smi=smi, torch=torch.__version__,
          cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(),
          capability=list(torch.cuda.get_device_capability(0)))
    return smi


def phase_build(ops) -> None:
    t0 = time.perf_counter()
    logs = ops.build_kernels()
    seconds = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "Used" in ln or "spill" in ln]
             for name, log in logs.items()}
    _emit("build", seconds=seconds, build_dir=str(ops.build_dir()),
          ptxas=ptxas)


def phase_kernels(torch, ops, ref):
    """Every kernel against its plain version at the main path's shapes."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    dev = "cuda"

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale) \
            .to(torch.bfloat16)

    cases = {name: [] for name in KERNEL_ROWS}

    def run(kernel, label, launches_per_step, fn, plain, library, n_bytes,
            flops, flop_rate, reps, plain_reps):
        got, want = fn(), plain()
        torch.cuda.synchronize()
        abs_err, rel_err, ok = _compare(got, want)
        del got, want
        bound, bound_by = _bound_ms(n_bytes, flops, flop_rate)
        row = dict(kernel=kernel, case=label, max_abs_err=abs_err,
                   max_rel_err=rel_err, within_tol=ok,
                   launches_per_step=launches_per_step,
                   ms=_time_ms(torch, fn, reps),
                   plain_ms=_time_ms(torch, plain, plain_reps),
                   library_ms=(_time_ms(torch, library, reps) if library
                               else None),
                   bound_ms=bound, bound_by=bound_by)
        _emit("kernels", **row)
        _check(ok, f"{kernel} {label}: max abs err {abs_err} beyond "
                   f"atol={ATOL}, rtol={RTOL}")
        cases[kernel].append(row)

    # rmsnorm: ln1/ln2 (h), q_norm (d_cq), kv_norm (d_c) over 4096 rows;
    # SMOKE widths and a width off the 16-byte path for coverage
    rms_lib = getattr(F, "rms_norm", None)
    for h, per_step, gemma in ((7168, 2, False), (1536, 1, False),
                               (512, 1, False), (7168, 0, True),
                               (96, 0, False), (100, 0, False)):
        x = randn(4096, h)
        s = (1.0 + randn(h, scale=0.1).float()).to(torch.bfloat16)
        library = None
        if rms_lib is not None and not gemma:
            library = (lambda x=x, s=s, h=h: rms_lib(x, (h,), weight=s,
                                                     eps=1e-6))
        run("rmsnorm", f"rows=4096 h={h}" + (" gemma" if gemma else ""),
            per_step,
            lambda x=x, s=s, g=gemma: ops.rmsnorm(x, s, eps=1e-6,
                                                  gemma_style=g),
            lambda x=x, s=s, g=gemma: ref.rmsnorm_ref(x, s, eps=1e-6,
                                                      gemma_style=g),
            library, 2 * 4096 * h * 2 + h * 2, 4 * 4096 * h, FP32_FLOPS,
            reps=50, plain_reps=20)
        del x, s

    # flash: DeepSeek-v3 MLA heads at s=4096, a ragged s, the SMOKE heads
    for b, s, nh, dq, dv, per_step in ((1, 4096, 128, 192, 128, 1),
                                       (1, 4000, 128, 192, 128, 0),
                                       (2, 32, 4, 48, 32, 0)):
        q, k, v = randn(b, s, nh, dq), randn(b, s, nh, dq), randn(b, s, nh, dv)
        scale = dq ** -0.5
        pairs = s * (s + 1) // 2
        run("flash_attention", f"b={b} s={s} n_h={nh} dq={dq} dv={dv}",
            per_step,
            lambda q=q, k=k, v=v, sc=scale: ops.flash_attention(
                q, k, v, scale=sc, causal=True),
            lambda q=q, k=k, v=v, sc=scale: ref.flash_attention_ref(
                q, k, v, scale=sc, causal=True),
            lambda q=q, k=k, v=v, sc=scale: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True, scale=sc),
            b * s * nh * (2 * dq + 2 * dv) * 2, 2 * pairs * (dq + dv) * b * nh,
            BF16_TENSOR_FLOPS, reps=5, plain_reps=2)
        del q, k, v
        torch.cuda.empty_cache()

    # gmm: gate/up and down over the (E*C, h) dispatch rows, C=160 (4096
    # tokens, cf 1.25) with the static map; C=40 (1024 tokens) with a
    # shuffled map, which the model never makes but the kernel must honour;
    # the SMOKE train step's C=20 (32 tokens per micro-batch, 4 experts)
    for E, C, K, N, per_step, shuffle in (
            (256, 160, 7168, 2048, 2, False), (256, 160, 2048, 7168, 1, False),
            (256, 40, 7168, 2048, 0, True), (4, 20, 256, 128, 0, False),
            (4, 20, 128, 256, 0, False)):
        lhs = randn(E * C, K)
        rhs = randn(E, K, N, scale=K ** -0.5)
        if shuffle:
            emap = torch.randperm(E, generator=gen, device=dev) \
                .to(torch.int32)
        else:
            emap = torch.arange(E, dtype=torch.int32, device=dev)
        library = None
        if not shuffle:
            library = (lambda lhs=lhs, rhs=rhs, E=E, C=C, K=K: torch.bmm(
                lhs.view(E, C, K), rhs))
        n_experts = int(torch.unique(emap).numel())
        run("gmm", f"M={E * C} K={K} N={N} block_m={C}"
            + (" shuffled map" if shuffle else ""), per_step,
            lambda lhs=lhs, rhs=rhs, emap=emap, C=C: ops.gmm(
                lhs, rhs, emap, block_m=C),
            lambda lhs=lhs, rhs=rhs, emap=emap, C=C: ref.gmm_ref(
                lhs, rhs, emap, block_m=C),
            library,
            E * C * K * 2 + n_experts * K * N * 2 + E * C * N * 2 + E * 4,
            2 * E * C * K * N, BF16_TENSOR_FLOPS, reps=5, plain_reps=2)
        del lhs, rhs, emap
        torch.cuda.empty_cache()
    return cases


def _cut_spec(spec, n_layers: int, first_k_dense: int):
    return dataclasses.replace(
        spec, name=f"{spec.name}-{n_layers}l", n_layers=n_layers,
        moe=dataclasses.replace(spec.moe, first_k_dense=first_k_dense))


@contextlib.contextmanager
def _routing_log(moe_mod, log: list):
    """Record every MoE call's routing decisions while the block runs: the
    (T, K) expert ids from the router and each assignment's rank within
    its expert, by wrapping the two module functions that make them."""
    route, positions = moe_mod._route, moe_mod._positions_in_expert

    def recording_route(*args, **kwargs):
        out = route(*args, **kwargs)
        log.append(out[2])
        return out

    def recording_positions(*args, **kwargs):
        out = positions(*args, **kwargs)
        log.append(out[0])
        return out

    moe_mod._route, moe_mod._positions_in_expert = (recording_route,
                                                    recording_positions)
    try:
        yield
    finally:
        moe_mod._route, moe_mod._positions_in_expert = route, positions


@contextlib.contextmanager
def _fp32_attention(backend_mod, ref):
    """Run MLA attention through the plain flash version (fp32 scores and
    probabilities) in place of the naive one (bf16 scores and
    probabilities): a reference run that differs only in rounding."""
    naive = backend_mod.mla_attention

    def fp32(q, k, v, *, scale, impl="naive"):
        return ref.flash_attention_ref(q, k, v, scale=scale, causal=True)

    backend_mod.mla_attention = fp32
    try:
        yield
    finally:
        backend_mod.mla_attention = naive


def _routed_alike(a, b, spec, capacity_factor: float):
    """Per token of one MoE call in two runs (expert ids (T, K), rank within
    the expert): True where both chose the same expert set and kept or
    dropped each assignment alike."""
    T, K = a[0].shape
    C = int(max(1, round(T * K / spec.moe.n_routed * capacity_factor)))
    chosen = []
    for eids, pos in (a, b):
        # each token's expert set in ascending order, with keep per expert
        eids, order = eids.sort(dim=-1)
        chosen.append((eids, (pos.reshape(eids.shape) < C).gather(-1, order)))
    return (chosen[0][0] == chosen[1][0]).all(-1) \
        & (chosen[0][1] == chosen[1][1]).all(-1)


def phase_forward(torch, ops, ref, P):
    spec = _cut_spec(P.SPEC, 2, 1)
    opts = P.ModelOptions(backend="cuda", router_impl="sigmoid")
    model = P.build_model(spec, opts)
    model.init(SEED)
    reference = model.with_options(dataclasses.replace(opts,
                                                       backend="reference"))
    b, s = 1, 4096
    batch = P.make_batch(P.SyntheticConfig(b, s, spec.vocab, seed=SEED), 0,
                         "cuda")
    n_params = sum(p.numel() for p in model.parameters())
    runs = {}
    with torch.no_grad():
        for m in (model, reference):     # warm-up, outside the counted run
            m.loss(batch)
        for name, m in (("cuda", model), ("reference", reference)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            loss, met = m.loss(batch)   # the counted main-path run
            torch.cuda.synchronize()
            runs[name] = dict(loss=float(loss), aux=float(met["aux"]),
                              seconds=time.perf_counter() - t0,
                              launches=ops.launch_counts(),
                              peak_bytes=torch.cuda.max_memory_allocated())
        routing, gap = {}, {}
        for name, m in (("reference", reference), ("cuda", model),
                        ("reference_fp32_attention", reference)):
            routing[name] = []
            with contextlib.ExitStack() as stack:
                stack.enter_context(_routing_log(P.moe, routing[name]))
                if name == "reference_fp32_attention":
                    stack.enter_context(_fp32_attention(P.backend, ref))
                logits, _ = m.forward(batch)
            if name == "reference":
                want, logit_scale = logits, float(logits.float().abs().max())
                continue
            if name == "cuda":
                finite = bool(logits.isfinite().all())
                shape = tuple(logits.shape)
            # per token: largest |logit| gap over the vocabulary
            gap[name] = (logits.float() - want.float()).abs().amax(-1) \
                .reshape(-1)
            del logits
        del want
    # a token routed differently by two runs (another expert set among
    # near-tied sigmoid scores, or kept against dropped at capacity) gets
    # another MoE output; the 5% bound holds for the tokens routed alike
    T = b * s
    alike = {name: _routed_alike(routing[name], routing["reference"], spec,
                                 opts.capacity_factor) for name in gap}
    n_alike = int(alike["cuda"].sum())
    gap_alike = float(gap["cuda"][alike["cuda"]].max()) if n_alike \
        else float("nan")
    gap_other = float(gap["cuda"][~alike["cuda"]].max()) if n_alike < T \
        else 0.0
    w_alike = alike["reference_fp32_attention"]
    witness = dict(
        tokens_routed_alike=int(w_alike.sum()),
        logits_max_diff_routed_alike=float(
            gap["reference_fp32_attention"][w_alike].max()),
        tokens_routed_alike_with_cuda=int(
            _routed_alike(routing["cuda"], routing["reference_fp32_attention"],
                          spec, opts.capacity_factor).sum()))
    rel = abs(runs["cuda"]["loss"] - runs["reference"]["loss"]) \
        / abs(runs["reference"]["loss"])
    launches = runs["cuda"]["launches"]
    _emit("forward", spec=spec.name, n_params=n_params, b=b, s=s,
          router="sigmoid", runs=runs, loss_rel_diff=rel,
          tokens_routed_alike=n_alike, tokens=T,
          logits_max_diff_routed_alike=gap_alike,
          logits_max_diff_routed_otherwise=gap_other,
          logit_scale=logit_scale, reference_fp32_attention=witness)
    _check(finite and shape == (b, s, spec.vocab),
           "forward: logits not finite or misshapen")
    _check(launches == {"rmsnorm": 8, "flash_attention": 2, "gmm": 3},
           f"forward: launch counts {launches}")
    _check(not any(runs["reference"]["launches"].values()),
           "forward: reference backend launched kernels")
    _check(rel < FWD_LOSS_RTOL, f"forward: loss gap {rel}")
    _check(n_alike >= FWD_MIN_ALIKE * T,
           f"forward: only {n_alike} of {T} tokens routed alike")
    _check(gap_alike < FWD_LOGIT_SHARE * max(logit_scale, 1.0),
           f"forward: logits max diff {gap_alike} at scale {logit_scale}")
    return launches


def phase_train(torch, ops, P):
    spec = _cut_spec(P.SPEC, 1, 1)
    model = P.build_model(spec, P.ModelOptions(backend="cuda",
                                               router_impl="sigmoid"))
    model.init(SEED)
    b, s, n_steps = 2, 2048, 3
    data = P.batches(P.SyntheticConfig(b, s, spec.vocab, seed=SEED), "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    _, history = P.train(model, data, n_steps, P.TrainConfig(n_micro=2),
                         log_every=1)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = ops.launch_counts()
    losses = [h["loss"] for h in history]
    _emit("train", spec=spec.name,
          n_params=sum(p.numel() for p in model.parameters()), b=b, s=s,
          n_micro=2, steps=n_steps, losses=losses,
          grad_norms=[h["grad_norm"] for h in history],
          elapsed_s=[h["elapsed_s"] for h in history], seconds=seconds,
          launches=launches, peak_bytes=torch.cuda.max_memory_allocated())
    _check(len(losses) == n_steps and all(math.isfinite(x) for x in losses),
           f"train: losses {losses}")
    _check(launches["rmsnorm"] == 4 * 2 * n_steps
           and launches["flash_attention"] == 2 * n_steps,
           f"train: launch counts {launches}")
    return launches


def _train_gaps(torch, a, b, cfg, spec, capacity_factor: float) -> dict:
    """How far two train steps from the same state lie apart: loss and
    grad_norm (relative), m and v (relative norm over all leaves), the
    share of elements whose update differs by more than lr/20, and the
    tokens both routed alike over every micro-batch's MoE call."""
    (state_a, met_a, log_a), (state_b, met_b, log_b) = a, b
    gaps = {k: abs(float(met_a[k]) - float(met_b[k])) / abs(float(met_b[k]))
            for k in ("loss", "grad_norm")}
    gaps["m"] = _rel_norm(torch, state_a.m, state_b.m)
    gaps["v"] = _rel_norm(torch, state_a.v, state_b.v)
    # both start from the same master, so the master gap is the gap between
    # the updates they made
    diff = [(state_a.master[n] - state_b.master[n]).abs()
            for n in state_b.master]
    gaps["update_share"] = sum(int((d > cfg.adamw.lr / 20).sum())
                               for d in diff) / sum(d.numel() for d in diff)
    gaps["master_max_abs_diff"] = max(float(d.max()) for d in diff)
    calls = list(zip(log_a[0::2], log_a[1::2], log_b[0::2], log_b[1::2]))
    gaps["tokens_routed_alike"] = sum(
        int(_routed_alike((ea, pa), (eb, pb), spec, capacity_factor).sum())
        for ea, pa, eb, pb in calls)
    gaps["tokens"] = sum(int(ea.shape[0]) for ea, *_ in calls)
    return gaps


def phase_train_smoke(torch, ops, ref, P):
    spec = P.SMOKE
    models = {backend: P.build_model(spec, P.ModelOptions(
        backend=backend, router_impl="sigmoid"))
        for backend in ("cuda", "reference")}
    models["cuda"].init(SEED)
    init = {n: p.detach().clone()
            for n, p in models["cuda"].named_parameters()}
    batch = P.make_batch(P.SyntheticConfig(2, 32, spec.vocab, seed=SEED), 0,
                         "cuda")
    cfg = P.TrainConfig(n_micro=2)
    cf = P.ModelOptions().capacity_factor

    runs, launches = {}, {}
    for name, backend in (("cuda", "cuda"), ("reference", "reference"),
                          ("reference_fp32_attention", "reference")):
        model = models[backend].load_params(init)
        log = []
        ops.reset_launch_counts()
        with contextlib.ExitStack() as stack:
            stack.enter_context(_routing_log(P.moe, log))
            if name == "reference_fp32_attention":
                stack.enter_context(_fp32_attention(P.backend, ref))
            state, met = P.make_train_step(model, cfg)(
                P.init_train_state(dict(model.named_parameters())), batch)
        torch.cuda.synchronize()
        runs[name] = (state, met, log)
        launches[name] = ops.launch_counts()

    gaps = _train_gaps(torch, runs["cuda"], runs["reference"], cfg, spec, cf)
    _emit("train_smoke", spec=spec.name, b=2, s=32, n_micro=2,
          router="sigmoid",
          losses={n: float(r[1]["loss"]) for n, r in runs.items()},
          grad_norms={n: float(r[1]["grad_norm"]) for n, r in runs.items()},
          gaps=gaps, launches=launches,
          # witnesses: what rounding in the attention alone moves
          gaps_reference_fp32_attention=_train_gaps(
              torch, runs["reference_fp32_attention"], runs["reference"],
              cfg, spec, cf),
          gaps_cuda_to_reference_fp32_attention=_train_gaps(
              torch, runs["cuda"], runs["reference_fp32_attention"], cfg,
              spec, cf))
    # 2 layers x 4 norms, 2 layers x 1 flash, 1 MoE layer x 3 gmm; x n_micro
    _check(launches["cuda"] == {"rmsnorm": 16, "flash_attention": 4,
                                "gmm": 6},
           f"train_smoke: launch counts {launches['cuda']}")
    _check(not any(n for name, counts in launches.items() if name != "cuda"
                   for n in counts.values()),
           f"train_smoke: reference backend launched kernels {launches}")
    _check(gaps["loss"] < TRAIN_RTOL and gaps["grad_norm"] < TRAIN_RTOL,
           f"train_smoke: gaps {gaps}")
    _check(gaps["m"] < TRAIN_MV_RTOL and gaps["v"] < TRAIN_MV_RTOL,
           f"train_smoke: optimizer state gaps {gaps}")
    _check(gaps["update_share"] < TRAIN_UPDATE_SHARE,
           f"train_smoke: update differs in a share of "
           f"{gaps['update_share']} of the elements")
    _check(gaps["tokens_routed_alike"] >= FWD_MIN_ALIKE * gaps["tokens"],
           f"train_smoke: only {gaps['tokens_routed_alike']} of "
           f"{gaps['tokens']} tokens routed alike")
    return launches["cuda"]


def _import_port():
    """The port's entry points, from ``src/`` beside this script."""
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "__init__.py").is_file():
        _fail(f"the repro_torch package is not at {src}")
    sys.path.insert(0, str(src))
    from repro_torch.configs.deepseek_v3 import SMOKE, SPEC
    from repro_torch.data import SyntheticConfig, batches, make_batch
    from repro_torch.kernels import ops, ref
    from repro_torch.models import ModelOptions, backend, build_model, moe
    from repro_torch.optim import init_train_state
    from repro_torch.train import TrainConfig, make_train_step, train
    port = types.SimpleNamespace(
        SMOKE=SMOKE, SPEC=SPEC, SyntheticConfig=SyntheticConfig,
        batches=batches, make_batch=make_batch, ModelOptions=ModelOptions,
        build_model=build_model, backend=backend, moe=moe,
        init_train_state=init_train_state,
        TrainConfig=TrainConfig, make_train_step=make_train_step, train=train)
    return ops, ref, port


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        _fail("no CUDA device (torch.cuda.is_available() is false)")
    ops, ref, port = _import_port()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    phase_card(torch)
    phase_build(ops)
    cases = phase_kernels(torch, ops, ref)
    torch.cuda.empty_cache()
    fwd = phase_forward(torch, ops, ref, port)
    torch.cuda.empty_cache()
    trn = phase_train(torch, ops, port)
    torch.cuda.empty_cache()
    smoke = phase_train_smoke(torch, ops, ref, port)

    rows = []
    for name, (source, replaces) in KERNEL_ROWS.items():
        head = cases[name][0]   # the first case is the main path's shape
        _check(fwd[name] > 0, f"{name} never launched on the main path")
        rows.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=fwd[name], max_abs_err=max(c["max_abs_err"]
                                                for c in cases[name]),
            ms=head["ms"], plain_ms=head["plain_ms"],
            bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=head["library_ms"], case=head["case"],
            launches_train_full=trn[name], launches_train_smoke=smoke[name]))
    _emit("done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
