"""Does RecurrentGemma-9B's short tensor-parallel bf16 program read four
times its rounding control because its partial sums are rounded to bf16
before they are added across ranks?

    python3 tools/tp_psum_f32.py

On the card, it runs ``chip_smoke.py``'s short program of the hybrid
family (``tpf_config("recurrentgemma_9b", "short")``: one group of three
layers at published widths, bf16 on the kernels, B=1, S=4096: a prefill,
the loss and its gradients) on four gloo ranks sharing the card over the
(2, 2) mesh, twice: as the package runs it, and with ``collectives.psum``
wrapped here (not in the package) so that a bf16 input is summed in
float32 and rounded once afterwards, which is what a row-parallel layer's
partial sums, the vocab-parallel embedding and the cross-entropy's sums
go through.  The parent holds each run against the one-rank program on the
kernels on the same parameters and batch, as ``chip_smoke.py``'s
``tpf_checks`` does, beside the control that check records: the one-rank
plain path against the one-rank kernels, the distance between two right
bf16 programs.

It prints the card's name and power limit, then one JSON line: for each
run, the last-token logits' relative L2, the loss's relative error and
every gradient leaf's relative L2 (in the parameter tree's order), and
for the control the same; each run's worst leaf, and the first leaf in
tree order whose reading exceeds three times its control.
"""
import json
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

ARCH = "recurrentgemma_9b"
CONTROL_FACTOR = 3.0


def _short(rank, tmp, seed, f32):
    """A rank's short program; with ``f32`` every bf16 ``psum`` is summed
    in float32."""
    from repro_torch.fabric import collectives as coll
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.launch.steps import _value_and_grad, build_step
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.parallel import (ShardCtx, layout_specs,
                                             shard_params)
    if f32:
        plain_psum = coll.psum

        def psum(x, group=None):
            if x.dtype == torch.bfloat16:
                return plain_psum(x.float(), group).to(x.dtype)
            return plain_psum(x, group)

        coll.psum = psum
    for mod in cs._kernel_modules():
        mod.library()                              # built by the parent
    mesh = make_smoke_mesh(*cs.TP_MESH)
    ctx = ShardCtx.launched(mesh)
    i = cs.TPF_ARCHS.index(ARCH)
    short = cs.tpf_config(ARCH, "short")
    sb = build_step(short, ShapeConfig("train", cs.TRAIN_SEQ, 1, "train"),
                    mesh, multi_pod=False, shard=ctx)
    full = cs.tp_params(short, seed + 50 + i)
    params = shard_params(full, layout_specs(sb.model), mesh, ctx.coords)
    del full
    rows = sb.model.shard.batch_rows(1)
    mine = {k: v[rows] for k, v in cs.tpf_batch(
        cs.tpf_config(ARCH), cs.TRAIN_SEQ, seed).items()}
    with torch.no_grad():
        cs._save(tmp, f"prefill_{rank}.pt",
                 sb.model.prefill(params, cs._no_labels(mine)))
    loss, grads = _value_and_grad(sb.model, params, mine)
    torch.cuda.synchronize()
    cs._save(tmp, f"grads_{rank}.pt", grads)
    return {"rank": rank, "loss": float(loss)}


def _bf16_body(rank, tmp, seed):
    return _short(rank, tmp, seed, False)


def _f32_body(rank, tmp, seed):
    return _short(rank, tmp, seed, True)


def run(body):
    """The ranks' logits and gradients unsharded, and rank 0's loss."""
    import torch.multiprocessing as mp
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models.lm import build_model
    from repro_torch.models.parallel import layout_specs
    n = cs.TP_MESH[0] * cs.TP_MESH[1]
    mesh = make_smoke_mesh(*cs.TP_MESH)
    with tempfile.TemporaryDirectory(prefix="tp_psum_") as tmp:
        ctx = mp.start_processes(cs.tp_rank, args=(n, tmp, cs.SEED, body),
                                 nprocs=n, join=False, start_method="spawn")
        cs.join_ranks(ctx, cs.TP_TIMEOUT, "tp_psum_f32", tmp)
        with open(os.path.join(tmp, "rank0.json")) as f:
            loss = json.load(f)["loss"]
        model = build_model(cs.tpf_config(ARCH, "short"))
        logits = cs._unshard(tmp, "prefill", (None, "model"), mesh)
        grads = cs._unshard(tmp, "grads", layout_specs(model), mesh)
    return logits, grads, loss


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("tp_psum_f32 runs on a CUDA device")
    import dataclasses
    from repro_torch.kernels import build
    from repro_torch.launch.steps import _value_and_grad
    from repro_torch.models.common import leaf_names, tree_leaves
    from repro_torch.models.lm import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    build.build_libraries({m.LIB_NAME: m.SOURCES
                           for m in cs._kernel_modules()})
    runs = {"bf16_psum": run(_bf16_body), "f32_psum": run(_f32_body)}

    i = cs.TPF_ARCHS.index(ARCH)
    short = cs.tpf_config(ARCH, "short")
    model = build_model(short)
    plain = build_model(dataclasses.replace(short, kernel_mode="torch"))
    params = cs.tp_params(short, cs.SEED + 50 + i)
    batch = cs.tpf_batch(cs.tpf_config(ARCH), cs.TRAIN_SEQ, cs.SEED)
    names = leaf_names(params)
    with torch.no_grad():
        ref = model.prefill(params, cs._no_labels(batch)).float()
        plain_ref = plain.prefill(params, cs._no_labels(batch)).float()
    loss, grads = _value_and_grad(model, params, batch)
    plain_loss, plain_grads = _value_and_grad(plain, params, batch)
    grads, plain_grads = tree_leaves(grads), tree_leaves(plain_grads)
    control = [cs.rel_l2(p, w) for p, w in zip(plain_grads, grads)]
    out = {"arch": ARCH, "layers": short.n_layers, "S": cs.TRAIN_SEQ,
           "mesh": list(cs.TP_MESH), "leaves": names,
           "control": {"logits_rel_l2": cs.rel_l2(plain_ref, ref),
                       "loss_rel_err": abs(float(plain_loss) - float(loss))
                       / abs(float(loss)), "grad_rel_l2": control}}
    for key, (logits, got, rank_loss) in runs.items():
        errs = [cs.rel_l2(g.cuda(), w) for g, w in zip(tree_leaves(got),
                                                       grads)]
        worst = max(range(len(errs)), key=errs.__getitem__)
        first = next((names[j] for j, (e, c) in enumerate(zip(errs, control))
                      if e > CONTROL_FACTOR * c), None)
        out[key] = {"logits_rel_l2": cs.rel_l2(logits.cuda().float(), ref),
                    "loss_rel_err": abs(rank_loss - float(loss))
                    / abs(float(loss)),
                    "grad_rel_l2": errs, "worst_leaf": names[worst],
                    "worst_rel_l2": errs[worst],
                    "first_leaf_over_3x_control": first}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
