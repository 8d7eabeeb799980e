"""Offline prefill of documents: a closed loop of one request at a time
through the port's ``DenseLM.prefill`` at B=1, each request's answer its
last token's logits, read back to the host.

Lengths come in blocks (``traffic.length_blocks``: ``counts[i]``
requests of ``lengths[i]`` each, shuffled by the seed), and the window
takes whole blocks until ``--seconds`` have passed, so every window holds
the same mix.  A request's latency runs from its dispatch to its logits
on the host.  Set-up warms up one prefill of each length.  Once the
window has closed, a sample drawn from the seed (``checked_per_length``
requests of each length, the longest among them) is run through the
float32 reference, and each length is held on its own: the least of its
requests' relative L2 distances of the program's logits from the
reference's is compared with the limit, so that every length fails where
its answers are wrong.  Not the widest: a top-2 choice that flips on
rounding near the last token moves an answer by 10-30 times the others,
on either precision, in about one request of five.
"""
from __future__ import annotations

import time

import numpy as np

WARM_INDEX = 10 ** 6            # request indices of the warm-up and trace


def run(b) -> None:
    import torch

    from port_bench import bench, program, roofline, traffic, weights

    cfg, t = b.config, b.cell["traffic"]
    V, dev = cfg["vocab_size"], b.device
    model = program.model(cfg, dev)
    params = weights.make(cfg, b.seed, dev)
    program.check_layout(model, params)

    def prefill(tokens: np.ndarray):
        x = torch.from_numpy(tokens).to(dev)[None]
        with b.span("prefill.request"):
            out = model.prefill(params, {"tokens": x})[0, :V].float().cpu()
        return out

    with torch.inference_mode():
        for j, n in enumerate(t["lengths"]):
            prefill(traffic.prompt(b.seed, WARM_INDEX + j, n, V))

        blocks = traffic.length_blocks(b.seed, t["lengths"], t["counts"])
        answers, lengths, latency = {}, [], []
        deadline = b.begin_window() + b.seconds
        while True:
            for n in next(blocks):
                i = len(lengths)
                tokens = traffic.prompt(b.seed, i, n, V)
                t0 = time.perf_counter()
                answers[i] = prefill(tokens)
                latency.append(time.perf_counter() - t0)
                lengths.append(n)
            if time.perf_counter() >= deadline:
                break
        b.end_window()
        b.attempted = len(lengths)
        b.failed = sum(not bool(torch.isfinite(a).all())
                       for a in answers.values())
        b.e2e["prefill_tokens_per_s"] = sum(lengths) / b.window_s
        b.e2e["prefill_p95_ms"] = bench.quantile(latency, 0.95) * 1e3
        b.work.update(
            window_flops=sum(roofline.prefill_flops(cfg, n)
                             for n in lengths),
            requests=len(lengths))

        order = sorted(t["lengths"])
        traced_lengths = order * t["traced_blocks"]

        def traced():
            for j, n in enumerate(traced_lengths):
                prefill(traffic.prompt(b.seed, WARM_INDEX + j, n, V))
        b.traced(traced, units=t["traced_blocks"])
        b.work["traced_crossbar_bytes"] = sum(
            roofline.crossbar_bytes(cfg, n, False) for n in traced_lengths)
        b.work["traced_flash_least_s"] = sum(
            roofline.flash_least_s(cfg, 1, n, False) for n in traced_lengths)

    del model
    program.free()
    sample = pick(b.seed, lengths, t["checked_per_length"])
    readings = ref_check(b, cfg, params, answers, lengths, sample)
    b.work["readings"] = readings
    limit = b.cell["limits"]["logits_rel_l2_min"]
    for n, least in per_length(readings, lengths).items():
        b.check(f"logits_rel_l2_min.{n}", least, limit)


def per_length(readings: dict, lengths) -> dict:
    """The least reading of each length's requests (keys: request index
    as a string)."""
    out = {}
    for i, v in readings.items():
        n = lengths[int(i)]
        out[n] = min(out.get(n, v), v)
    return dict(sorted(out.items()))


def pick(seed: int, lengths, per_length: int) -> list:
    """``per_length`` requests of each length, drawn from the seed (the
    longest length among them)."""
    rng = np.random.default_rng([seed % (1 << 63), 4])
    out = []
    for n in sorted(set(lengths)):
        idx = [i for i, m in enumerate(lengths) if m == n]
        out += [idx[j] for j in rng.permutation(len(idx))[:per_length]]
    return sorted(out)


def ref_check(b, cfg, params, answers, lengths, sample):
    """Each sampled request's relative L2 distance of the program's
    last-token logits from the float32 reference's."""
    import torch

    from port_bench import program, traffic
    from port_bench.reference import mixtral as ref
    readings, b.work["ref_out"], b.work["margins"] = {}, {}, {}
    for i in sample:
        tokens = torch.from_numpy(traffic.prompt(
            b.seed, i, lengths[i], cfg["vocab_size"])).to(b.device)
        probe = []
        with ref.tf32_off():
            want = ref.logits_at(params, tokens, cfg, probe=probe)[0]
        readings[i] = program.rel_l2(answers[i].to(b.device), want)
        b.work["ref_out"][i] = (lengths[i], want.cpu())
        b.work["margins"][str(i)] = (
            min(p["capacity_margin"] for p in probe),
            min(p["router_margin"] for p in probe))
    return {str(k): v for k, v in readings.items()}
