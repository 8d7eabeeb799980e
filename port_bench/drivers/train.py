"""Training: the port's train step (``launch.steps.make_train_step`` with
its AdamW on the cosine schedule), fed by its ``DataPipeline``, steps back
to back as ``runtime.train.TrainLoop`` runs them.

Set-up builds the one train step, its model and optimizer state from the
seed's weights and runs its first steps through the window's own call and
feed (also the warm-up: every shape of the window).  The reference
follows the first three: each step's loss, the norm of each leaf's first
gradient as the optimizer got it (from its first moment after step 1),
that gradient's elements at a sample of places drawn from the seed, and
the norm of each leaf's change after step 3, before step 4 runs.  The
window then
takes steps until ``--seconds`` have passed; ``--trace 1`` then profiles
``traced_steps`` more.
"""
from __future__ import annotations

import math
import time

import numpy as np

CHECKED_STEPS = 3
SAMPLED = 1 << 20               # first-gradient elements kept a leaf


def sample_index(seed: int, named) -> dict:
    """Flat indices of each leaf's sampled elements, drawn from the seed:
    every element of a leaf of at most ``SAMPLED``, else ``SAMPLED`` of
    them."""
    import torch
    out = {}
    for j, (n, t) in enumerate(named):
        size = t.numel()
        if size <= SAMPLED:
            out[n] = torch.arange(size, device=t.device)
            continue
        gen = torch.Generator(device=t.device)
        gen.manual_seed((seed * 1009 + j) % (1 << 62))
        out[n] = torch.randint(0, size, (SAMPLED,), generator=gen,
                               device=t.device)
    return out


def run(b) -> None:
    import torch

    from port_bench import program, roofline, weights
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.launch.steps import make_train_step

    cfg, t = b.config, b.cell["traffic"]
    B, S, V = t["batch"], t["seq_len"], cfg["vocab_size"]
    dev = b.device
    model = program.model(cfg, dev, train=True)
    params = weights.make(cfg, b.seed, dev)
    program.check_layout(model, params)
    opt = program.adamw(t["optimizer"])
    step = make_train_step(model, opt)
    state = opt.init(params)
    pipe = DataPipeline(seed=b.seed, global_batch=B, seq_len=S, vocab=V,
                        kind="train", prefetch_depth=2)
    pipe.start()
    fed = []

    def feed():
        got = next(pipe)
        if len(fed) < CHECKED_STEPS:
            fed.append(got)
        return {k: torch.from_numpy(v).to(dev) for k, v in got.items()}

    def one():
        nonlocal params, state
        with b.span("pipeline.next"):
            batch = feed()
        with b.span("train.step"):
            params, state, loss = step(params, state, batch)
            return float(loss)

    # the checked steps, which also warm up every shape of the window
    p0 = [x.detach().clone() for _, x in weights.leaves(params)]
    losses = []
    for i in range(CHECKED_STEPS):
        losses.append(one())
        if i == 0:
            b1 = t["optimizer"]["b1"]
            moments = weights.leaves(state.m)
            first = {n: float(m.norm()) / (1 - b1) for n, m in moments}
            sample = sample_index(b.seed, moments)
            first_at = {n: m.reshape(-1)[sample[n]] / (1 - b1)
                        for n, m in moments}
            del moments
    change = {n: float((x.detach().float() - x0.float()).norm())
              for (n, x), x0 in zip(weights.leaves(params), p0)}
    del p0

    deadline = b.begin_window() + b.seconds
    n = 0
    while True:
        loss = one()
        n += 1
        if not math.isfinite(loss):
            b.failed += 1
        if time.perf_counter() >= deadline:
            break
    b.end_window()
    b.attempted = n
    b.e2e["train_tokens_per_s"] = n * B * S / b.window_s
    step_flops = roofline.train_flops(cfg, B, S)
    b.work["window_flops"] = n * step_flops
    k = t["traced_steps"]

    def traced():
        for _ in range(k):
            one()
    b.traced(traced, units=k)
    b.work["traced_crossbar_bytes"] = k * roofline.crossbar_bytes(
        cfg, B * S, True)
    b.work["traced_flash_least_s"] = k * roofline.flash_least_s(
        cfg, B, S, True)
    pipe.stop()

    # the comparison, once the program's state is freed
    del params, state, step, model, opt
    program.free()
    ref_check(b, cfg, t, losses, first, change, fed, sample, first_at)


def ref_check(b, cfg, t, losses, first, change, fed, sample,
              first_at) -> None:
    import torch

    from port_bench import traffic, weights
    from port_bench.reference import mixtral as ref
    B, S, V = t["batch"], t["seq_len"], cfg["vocab_size"]
    seeded = [traffic.train_tokens(b.seed, s, B, S, V)
              for s in range(CHECKED_STEPS)]
    for s, (got, want) in enumerate(zip(fed, seeded)):
        if any(not np.array_equal(got[k], want[k]) for k in want):
            b.fail(f"the pipeline's batch {s} is not the seeded stream's")
    batches = [{k: torch.from_numpy(v).to(b.device) for k, v in x.items()}
               for x in seeded]
    ref_out = ref.adamw_steps(weights.make(cfg, b.seed, b.device), batches,
                              cfg, t["optimizer"], sample)
    b.work["ref_out"], b.work["sample"] = ref_out, sample
    nums = compare(losses, first, change, first_at, *ref_out)
    b.work["readings"] = {**nums, "losses": losses, "ref_losses": ref_out[0]}
    lim = b.cell["limits"]
    for name in sorted(lim):
        b.check(name, nums[name], lim[name])
    if not all(math.isfinite(x) for x in losses):
        b.fail(f"a checked step's loss is not finite: {losses}")


def compare(losses, first, change, first_at, r_losses, r_first, r_change,
            r_raw, r_first_at):
    """The readings: the gaps of the three losses; of each leaf's first
    gradient norm and of its change's norm, each measured against the
    reference's norm of that leaf or of the median leaf, whichever is
    larger, by the worst leaf and by the median leaf; and each leaf's
    relative L2 distance of the sampled first-gradient elements from the
    reference's, by the median and the worst leaf.  Leaves whose
    reference gradient is under a thousandth of the median leaf's move by
    round-off alone and are left out of the change and the distances.
    The cell's ``limits`` name the readings compared."""
    from port_bench import program
    loss_gaps = [abs(a - r) for a, r in zip(losses, r_losses)]
    med_g = float(np.median(list(r_first.values())))
    grad = {n: abs(first[n] - r) / max(r, med_g) for n, r in r_first.items()}
    med_raw = float(np.median(list(r_raw.values())))
    kept = [n for n, g in r_raw.items() if g >= 1e-3 * med_raw]
    med_c = float(np.median([r_change[n] for n in kept]))
    chg = {n: abs(change[n] - r_change[n]) / max(r_change[n], med_c)
           for n in kept}
    rel = {n: program.rel_l2(first_at[n], r_first_at[n]) for n in kept}
    return {"loss_gap": max(loss_gaps), "loss_gaps": loss_gaps,
            "grad_rel_median": float(np.median(list(rel.values()))),
            "grad_rel_gap": max(rel.values()),
            "grad_rel_worst_leaf": max(rel, key=rel.get),
            "grad_rels": rel,
            "grad_gap": max(grad.values()),
            "grad_median": float(np.median(list(grad.values()))),
            "change_median": float(np.median(list(chg.values()))),
            "grad_worst_leaf": max(grad, key=grad.get),
            "change_gap": max(chg.values()),
            "change_worst_leaf": max(chg, key=chg.get),
            "grad_gaps": grad, "change_gaps": chg,
            "left_out": sorted(set(r_raw) - set(kept))}
