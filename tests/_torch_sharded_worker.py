"""Rank bodies of the sharded tests, and the spawn that runs them.

Imports only torch, numpy and ``repro_torch`` (never JAX), so a spawned
rank starts quickly and the card's tests can use it too.  Inputs reach the
ranks as numpy arrays, and each rank's results come back as numpy arrays
(pickled into a file per rank); the JAX side of a comparison runs in the
test process.

:func:`spawn` starts ``n`` ranks with ``torch.multiprocessing`` (start
method ``spawn``) on a ``file://`` store under the test's temporary
directory, so no TCP port is taken and parallel test workers cannot
collide.  It waits at most ``timeout`` seconds: a rank that raises fails
the call with its traceback, and a rank that hangs (its peers waiting in a
collective) is killed with the others and fails it too.
"""
import os
import pickle
import time

import numpy as np
import torch

SPAWN_TIMEOUT = 60.0


def spawn(body: str, n: int, tmp_path, payload, *, backend: str = "gloo",
          device: str = "cpu", timeout: float = SPAWN_TIMEOUT):
    """Run rank body ``body`` (a function of this module) on ``n`` ranks;
    returns the ranks' results in rank order."""
    import torch.multiprocessing as mp
    out_dir = os.path.join(str(tmp_path), f"ranks-{body}")
    os.makedirs(out_dir, exist_ok=True)
    store = "file://" + os.path.join(out_dir, "store")
    ctx = mp.start_processes(_entry, args=(n, body, store, backend, device,
                                           payload, out_dir),
                             nprocs=n, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"ranks of {body} still running after "
                                   f"{timeout} s")
    except Exception as e:
        # the peers of a failed rank fail too: show every rank's own error
        texts = []
        for r in range(n):
            path = os.path.join(out_dir, f"rank{r}.err")
            if os.path.exists(path):
                with open(path) as f:
                    texts.append(f"--- rank {r}\n{f.read()}")
        raise RuntimeError(f"{body}: {e}\n" + "\n".join(texts)) from e
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
    results = []
    for r in range(n):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


def _entry(rank, n, body, store, backend, device, payload, out_dir):
    import torch.distributed as dist
    torch.set_num_threads(1)
    if device.startswith("cuda"):
        torch.cuda.set_device(torch.device(device))
    dist.init_process_group(backend, init_method=store, rank=rank,
                            world_size=n)
    try:
        result = globals()[body](rank, n, payload, device)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        import traceback
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


# ----------------------------------------------------------------------
# helpers
# ----------------------------------------------------------------------
def registers(d, device="cpu"):
    from repro_torch.core.registers import CrossbarRegisters
    return CrossbarRegisters(**{k: torch.as_tensor(np.asarray(v),
                                                   device=device)
                                for k, v in d.items()})


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_np(v) for v in x)
    return x


PLAN = ("keep", "slot", "dst", "error", "counts", "drops")


# ----------------------------------------------------------------------
# the sharded fabric backend
# ----------------------------------------------------------------------
def fabric_cases(rank, n, payload, device):
    """Per case: this rank's plan (with the sanitizer on), slabs, combine
    with and without a persisted route, and the dispatch and combine
    gradients beside the one-hot backward oracles; whether the strict
    sanitizer raised; the refusal of a port count the ranks cannot
    split."""
    from repro_torch.core import arbiter
    from repro_torch.fabric import Fabric, FabricCheckError
    from repro_torch.fabric.backends import (sharded_combine_at_bwd_ref,
                                             sharded_dispatch_at_bwd_ref)
    out = []
    for case in payload["cases"]:
        regs = registers(case["regs"], device)
        cap = case["cap"]
        S = regs.n_ports
        pps = S // n
        T = case["dst"].shape[0] // n
        sl = slice(rank * T, (rank + 1) * T)
        blk = slice(rank * pps, (rank + 1) * pps)
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a),
                                      device=device)
        dst = t(case["dst"][sl])
        src = torch.zeros_like(dst)                    # the rank wins
        fab = Fabric(regs, backend="sharded", capacity=cap, device=device,
                     debug="sanitize")
        plan = fab.plan(dst, src)
        x = t(case["x"][sl]).requires_grad_()
        slabs, _ = fab.dispatch(x, dst, src)
        G = t(case["G"][blk])
        (d_x,) = torch.autograd.grad(slabs, x, G)
        addr = arbiter.flat_slot_addr(plan, S, cap)
        d_x_ref = sharded_dispatch_at_bwd_ref(None, (n, pps, cap), G, addr)
        y = t(case["Y"][blk]).requires_grad_()
        w = t(case["w"][sl]).requires_grad_()
        comb = fab.combine(y, plan, w)
        route = fab.backend.build_route(plan, cap)
        comb_route = fab.backend.combine(y.detach(), plan, w.detach(),
                                         route=route)
        ct = t(case["ct"][sl])
        d_y, d_w = torch.autograd.grad(comb, [y, w], ct)
        W = route.addr_recv.shape[-1]
        idx = route.dshard * W + route.pos.clamp(max=W - 1)
        d_y_ref, d_w_ref = sharded_combine_at_bwd_ref(
            None, n, ct, y.detach(), route.addr_recv, idx, route.keep,
            w.detach())
        strict = Fabric(regs, backend="sharded", capacity=cap, device=device,
                        debug="strict")
        try:
            strict.plan(dst, src)
            raised = False
        except FabricCheckError:
            raised = True
        out.append(_np(dict(
            plan={f: getattr(plan, f) for f in PLAN}, slabs=slabs,
            comb=comb, comb_route=comb_route, d_x=d_x, d_x_ref=d_x_ref,
            d_y=d_y, d_w=d_w, d_y_ref=d_y_ref, d_w_ref=d_w_ref,
            strict_raised=raised, trace_count=fab.trace_count)))
    regs6 = registers(payload["regs6"], device)
    fab6 = Fabric(regs6, backend="sharded", capacity=4, device=device)
    try:
        fab6.plan(torch.zeros(4, dtype=torch.int32, device=device),
                  torch.zeros(4, dtype=torch.int32, device=device))
        refused = ""
    except ValueError as e:
        refused = str(e)
    return {"cases": out, "refused": refused}


# ----------------------------------------------------------------------
# sharded MoE
# ----------------------------------------------------------------------
def _moe_config(payload):
    from repro_torch.models.config import MoEConfig
    return MoEConfig(**payload["moe"])


def _moe_run(params, x, moe, ct, aux_c, **kw):
    """``moe_forward_sharded``, then the gradients of ``sum(y * ct) + aux_c
    * aux_loss`` in ``x`` and every parameter."""
    from repro_torch.models.moe import moe_forward_sharded
    leaves = {k: v.detach().clone().requires_grad_()
              for k, v in params.items()}
    xg = x.detach().clone().requires_grad_()
    y, stats = moe_forward_sharded(leaves, xg, moe, "swiglu", **kw)
    loss = (y * ct).sum() + aux_c * stats["aux_loss"]
    grads = torch.autograd.grad(loss, [xg, *leaves.values()])
    return y, stats, dict(zip(["x", *leaves], grads))


def moe_cases(rank, n, payload, device):
    """``moe_forward_sharded`` at each (capacity, expert mask) case:
    output, stats and gradients; ``moe_apply(dispatch_impl="sharded")`` on
    this rank's tokens and expert block; a ``Shell`` reconfigured between
    two calls; the refusal of an expert count the ranks cannot split."""
    from repro_torch.core.elastic import Region
    from repro_torch.core.module import ModuleFootprint
    from repro_torch.fabric import collectives as coll
    from repro_torch.models.moe import (moe_apply, moe_fabric,
                                        moe_forward_sharded)
    from repro_torch.shell import FailRegion, Grow, Shell, Submit
    moe = _moe_config(payload)
    t = lambda a: torch.as_tensor(np.asarray(a), device=device)
    params = {k: t(v) for k, v in payload["params"].items()}
    x, ct = t(payload["x"]), t(payload["ct"])
    out = []
    for cap, mask in payload["cases"]:
        m = None if mask is None else t(mask)
        y, stats, grads = _moe_run(params, x, moe, ct, payload["aux_c"],
                                   capacity=cap, expert_mask=m)
        out.append(_np(dict(y=y, stats=stats, grads=grads)))
    # the entry a layer calls, on this rank's tokens and expert block
    E_loc = moe.n_experts // n
    B_loc = x.shape[0] // n
    local = {"w_router": params["w_router"],
             "w_in": params["w_in"][rank * E_loc:(rank + 1) * E_loc],
             "w_out": params["w_out"][rank * E_loc:(rank + 1) * E_loc]}
    y_loc, stats_loc = moe_apply(local, x[rank * B_loc:(rank + 1) * B_loc],
                                 moe, "swiglu", dispatch_impl="sharded",
                                 capacity=payload["cases"][0][0])
    applied = _np(dict(y=coll.gather(y_loc, 0), stats=stats_loc))

    # a live shell: 3 regions + the host port = 4 ports = 4 experts
    GB = 1 << 30
    fp = lambda: ModuleFootprint(param_bytes=GB, flops_per_token=1e9,
                                 activation_bytes_per_token=4096)
    shell = Shell([Region(rid=i, n_chips=8, hbm_bytes=8 * GB)
                   for i in range(3)], capacity=payload["shell_cap"])
    shell.post(Submit(tenant="moe", footprints=(fp(), fp()), app_id=0))
    cap = payload["shell_cap"]
    y0, s0 = moe_forward_sharded(params, x, moe, "swiglu",
                                 registers=shell.registers, capacity=cap)
    fabric = moe_fabric(moe.n_experts, cap, "sharded", device=device)
    before = fabric.trace_count
    shell.post(Grow(tenant="moe", n_regions=3))
    shell.post(FailRegion(rid=1))
    y1, s1 = moe_forward_sharded(params, x, moe, "swiglu",
                                 registers=shell.registers, capacity=cap)
    reconf = _np(dict(y0=y0, s0=s0, y1=y1, s1=s1, before=before,
                      after=fabric.trace_count))

    bad = payload["params6"]
    moe6 = type(moe)(**{**payload["moe"], "n_experts": 6})
    try:
        moe_forward_sharded({k: t(v) for k, v in bad.items()}, x, moe6,
                            "swiglu")
        refused = ""
    except ValueError as e:
        refused = str(e)
    return {"cases": out, "applied": applied, "reconf": reconf,
            "refused": refused}


def shim_cases(rank, n, payload, device):
    """The deprecated ``exchange_sharded``/``combine_sharded`` shims: what
    this rank received (slabs and mask), its keep and slot, and the
    weighted combine of the received slabs doubled."""
    import warnings
    from repro_torch.core.crossbar import combine_sharded, exchange_sharded
    regs = registers(payload["regs"], device)
    cap = payload["cap"]
    T = payload["dst"].shape[0] // n
    sl = slice(rank * T, (rank + 1) * T)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
    dst, x, w = t(payload["dst"][sl]), t(payload["x"][sl]), t(payload["w"][sl])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        recv, mask, keep, slot = exchange_sharded(x, dst, regs, cap)
        back = combine_sharded(recv * 2.0, dst, keep, slot, w, cap)
    return _np(dict(recv=recv, mask=mask, keep=keep, slot=slot, back=back))


# ----------------------------------------------------------------------
# the card: kernels against plain versions on the same ranks
# ----------------------------------------------------------------------
def card_data_plane(rank, n, payload, device):
    """The sharded dispatch and combine, forward and backward, through the
    scatter and combine kernels and through their plain versions, on the
    same ranks and inputs; whether every pair is bit-equal, and the kernel
    launches of the kernel route."""
    from repro_torch.fabric import Fabric
    from repro_torch.kernels.crossbar_dispatch import kernel as K
    regs = registers(payload["regs"], device)
    cap = payload["cap"]
    S = regs.n_ports
    pps = S // n
    T = payload["dst"].shape[0] // n
    sl = slice(rank * T, (rank + 1) * T)
    blk = slice(rank * pps, (rank + 1) * pps)
    dt = getattr(torch, payload["dtype"])
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
    dst = t(payload["dst"][sl])
    src = torch.zeros_like(dst)
    res = {}
    K.reset_launch_counts()
    for mode in ("cuda", "torch"):
        fab = Fabric(regs, backend="sharded", capacity=cap, device=device,
                     kernel_mode=mode)
        x = t(payload["x"][sl]).to(dt).requires_grad_()
        w = t(payload["w"][sl]).to(dt).requires_grad_()
        slabs, plan = fab.dispatch(x, dst, src)
        y = slabs * t(payload["scale"][blk]).to(dt)
        out = fab.combine(y, plan, w)
        d_x, d_w = torch.autograd.grad(out, [x, w],
                                       t(payload["ct"][sl]).to(dt))
        res[mode] = (slabs, out, d_x, d_w)
        if mode == "cuda":
            launches = K.launch_counts()
    equal = [torch.equal(a, b) for a, b in zip(res["cuda"], res["torch"])]
    return {"equal": equal, "launches": launches,
            "d_w_dtype": str(res["cuda"][3].dtype)}


# ----------------------------------------------------------------------
# tensor parallelism: every family over a (data, model) mesh
# ----------------------------------------------------------------------
def tp_cases(rank, n, payload, device):
    """Per model case, this rank's local results on a (data, model) mesh
    of ``payload["mesh"]``: the loss and every local gradient leaf, the
    prefill logits (its rows, its vocab block), 4 teacher-forced
    ``decode_step`` logits (the encoder-decoder's with ``case["cross"]``,
    a global cross-attention cache, of which the rank keeps its rows and
    kv heads), the local parameters after one ``build_step`` train step
    whose clip bites, and ``ServeLoop``'s tokens (``case["serve"]``:
    slots, prompts, new tokens)."""
    import warnings
    import dataclasses
    from repro_torch.ckpt.convert import params_from_numpy
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.launch.steps import _value_and_grad, build_step
    from repro_torch.models.config import MoEConfig, ShapeConfig
    from repro_torch.models.lm import build_model
    from repro_torch.models.parallel import (ShardCtx, layout_specs,
                                             shard_params)
    from repro_torch.optim.adamw import AdamW
    mesh = make_smoke_mesh(*payload["mesh"])
    ctx = ShardCtx.launched(mesh)
    out = []
    for case in payload["cases"]:
        cfg = get_config(case["arch"], smoke=True)
        cfg = dataclasses.replace(cfg, dtype="float32", **(
            {"moe": MoEConfig(**case["moe"])} if case.get("moe") else {}))
        layout = layout_specs(build_model(cfg, device=device))
        full = params_from_numpy(case["params"], cfg, device=device)
        local = shard_params(full, layout, mesh, ctx.coords)
        batch = {k: torch.as_tensor(np.asarray(v), device=device)
                 for k, v in case["batch"].items()}
        B, S = batch["tokens"].shape
        shape = ShapeConfig("tp", S, B, "train")
        opt = AdamW(lr=case["lr"], grad_clip=case["grad_clip"])
        bundle = build_step(cfg, shape, mesh, multi_pod=False, opt=opt,
                            device=device, shard=ctx)
        model = bundle.model
        rows = model.shard.batch_rows(B)
        mine = {k: v[rows] for k, v in batch.items()}
        loss, grads = _value_and_grad(model, local, mine)
        res = {"loss": loss, "grads": grads}
        with torch.no_grad():
            res["prefill"] = model.prefill(
                local, {k: v for k, v in mine.items() if k != "labels"})
            state = model.init_decode_state(mine["tokens"].shape[0], 16)
            if case.get("cross") is not None:
                hl = model._heads
                kv = slice(hl.kv0, hl.kv0 + hl.n_kv)
                state = dataclasses.replace(state, **{
                    f: [torch.as_tensor(np.ascontiguousarray(
                        c[rows, :, kv]), device=device)
                        for c in case["cross"][f]]
                    for f in ("cross_k", "cross_v")})
            steps = []
            for t in range(case["decode_steps"]):
                logits, state = model.decode_step(
                    local, state, {"tokens": mine["tokens"][:, t:t + 1]})
                steps.append(logits)
            res["decode"] = torch.stack(steps)
        params = shard_params(full, layout, mesh, ctx.coords)
        new, _, step_loss = bundle.step(params, opt.init(params), mine)
        res["step_loss"] = step_loss
        res["stepped"] = new
        if case.get("serve"):
            from repro_torch.runtime.serve import Request, ServeLoop
            slots, prompts, new_tokens = case["serve"]
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", DeprecationWarning)
                loop = ServeLoop(cfg, batch=slots, max_len=32, device=device,
                                 params=shard_params(full, layout, mesh,
                                                     ctx.coords), shard=ctx)
            res["serve"] = [c.tokens for c in loop.serve(
                [Request(app_id=i, prompt=np.asarray(p), max_new=new_tokens)
                 for i, p in enumerate(prompts)])]
        out.append(_np(res))
    return {"coords": ctx.coords, "cases": out}
