"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line with its seconds:

1. device   needs ``torch.cuda.is_available()``; prints the card's name and
            power limit (``nvidia-smi``).
2. build    builds the crossbar, flash-attention, SSD, RG-LRU and Hamming
            kernel libraries from ``src/repro_torch`` (one ``nvcc`` each,
            started together).
3. kernels  holds ``plan_multi``, the fabric's plan entry
            (``plan_fabric``, and ``CudaBackend.plan`` around it),
            ``scatter`` and ``combine`` bit-equal (``torch.equal``) to
            their plain versions and the whole plan to
            ``ReferenceBackend.plan`` at the served shapes, the train
            step's (``moe_train``: T=2048, C=320) and large shapes, and
            times kernel, plain version and one library call with CUDA
            events (median of 20 after warm-up); at the decode, train and
            large shapes the plans, scatter, combine and their library
            calls also by device time (``torch.profiler``, 20 calls, with
            kernels and memsets per call) and host time per call (1,000
            calls enqueued on a busy card; ``repro_torch/kernels/timing.py``),
            and fails unless a plan (``plan_multi``, ``plan_fabric``,
            ``CudaBackend.plan``), scatter or combine call at the decode
            and train shapes is one device kernel and no memset.
3b. fabric_debug
            ``Fabric(backend="cuda_kernel", debug=...)`` at the decode and
            train shapes on clean traffic: plans, slabs and outputs under
            "sanitize" and "strict" bit-equal to ``debug=False``, the same
            crossbar launches a call; under "strict" a sprayed invalid
            destination and an over-capacity burst raise
            ``FabricCheckError`` (under "sanitize" they drop); one library
            load; each level's wall us a call of plan, dispatch, combine.
3c. moe_impls
            one Mixtral-8x7B MoE layer at its published widths at the
            train shape (T=4096, groups of 1024, bf16): the ``dense`` and
            ``gather`` impls against ``cuda_kernel``, outputs within 2e-2
            relative L2, grant counts and drops equal; each impl's ms.
4. flash    holds the flash-attention forward and backward kernels to
            their plain versions (autograd through ``attention_ref``) at
            twelve shapes (bfloat16 on the tensor-core kernels at head dims
            128 and 64, a window of 48 keys; Whisper-medium's encoder,
            1,500 frames not causal, and its cross-attention, 4,096
            queries against 1,500 keys; LLaVA-NeXT-34B's 56 query heads
            over 8 at S=4096; Command R+'s 96 over 8 at S=4096;
            Mixtral-8x22B's 48 over 8 at S=8192 under its window of 4096;
            float32 on the FMA kernels), and times
            kernel, plain version, ``scaled_dot_product_attention`` (where
            the window cuts keys, its memory-efficient backend with the
            window as a boolean mask) and
            the FMA kernels on the same bfloat16 inputs at the train shape
            and at the five model shapes (the kernels line's ``shapes``);
            at each of these six the bf16 backward's kernels' device ms
            (``flash_bwd.passes``), failing unless a call launches
            ``delta_kernel``, ``tc::dkdv_ws_kernel`` and
            ``tc::dq_ws_kernel`` once each and nothing else.
5. serve    a full-width Mixtral-8x7B (2 of 32 layers, bf16, random weights
            from a seed) behind ``ElasticServer`` on the ``cuda`` fabric,
            MoE on ``cuda_kernel``: 4 requests, one ``Shell.post(Grow)``
            midway.  Counts kernel launches on exactly this run, then serves
            the same requests through the plain versions on the card and
            requires identical token streams and port traffic.
5b. manager_mixtral
            the paper's resource manager closing the loop over that
            engine: one 4-module Mixtral tenant in a 4-region shell of
            80 GB regions, started on 1 region, ``ElasticServer`` with
            ``slots_per_region=1`` (a region buys a decode slot) on the
            ``cuda`` fabric and a ``Manager(Hysteresis())`` ticking with
            the server (deciding every second tick).  16 requests at tick
            0, then quiet to tick 72: the manager must post a Grow and
            later a Shrink, the placed regions must follow its decisions,
            and token streams, decisions and placements must equal the same
            loop on the plain path; the plan, scatter and combine kernels
            launch, the crossbar library loads once.
6. train    3 AdamW steps of ``build_step``'s train step (for
            ``train_4k`` cut to B=1, on the card mesh: ``make_train_step``)
            on the served model's
            parameters (B=1, S=4096), counting kernel launches on exactly
            these steps (bfloat16 flash only on the tensor-core route);
            then the prefill logits of the kernel path against
            the plain path, and one float32 loss and backward of a 1-layer
            full-width model on the kernel path against the plain path.
6b. train_loop
            ``TrainLoop.run_loop()`` on Mixtral-8x7B at its published widths
            cut to 1 layer (S=4096, batch 1, 4 steps, the MoE on the
            crossbar kernels) with a one-tenant ``Shell``, ``region=0`` and
            ``StragglerStats``: R keeps every activation; A runs remat
            "dots", checkpoints at step 2 (some 17 GB, into a temporary
            directory; it fails unless the disk holds twice that) and
            crashes; B resumes from A's checkpoint.  A's and B's losses
            equal R's bit for bit, B starts at step 2, its restored leaves
            equal A's files, no ``WatchdogTimeout``, the crossbar and flash
            kernels launch, one library load; step wall ms, peak memory
            with and without remat, and the checkpoint's save and restore
            seconds and GB/s.
7. ssd, rglru, flash_d256
            the recurrent families' kernels (built in phase 2 with the
            others) against their plain versions: SSD at Mamba-2 780M's
            widths (bf16 at S=4096 and 32768, float32 at S=1024 also
            against the sequential oracle, S=200 below the chunk; the bf16
            forward's passes' device ms at S=32768, ``ssd.passes``, which
            must be ``state_wg_kernel``, ``pass_kernel`` and
            ``out_wg_kernel`` once each and nothing else), RG-LRU
            at RecurrentGemma-9B's width (S=32768, and float32 with an
            initial state; the model's entry on bf16 u and float32 a, with
            and without an initial state, bit-equal to the float32 kernel
            followed by the cast, and one kernel a call, timed as
            ``entry_ms``), the flash forward at head dim 256 at
            RecurrentGemma's attention shape (S=32768, window 2048; bf16 on
            the tensor-core kernel, also timed on the FMA one); each timed
            against its plain version and its bound.
7b. smoke_widths
            every ported family's smoke config (head dims 8, 12 and 16;
            SSD at (P, N) = (16, 16), chunk 16) under ``kernel_mode="auto"``
            (``repro_torch.launch.smoke_widths``): bf16 prefill, float32
            loss and every family's gradients on the kernels (the SSM's and
            the hybrid's through the SSD and RG-LRU backward kernels)
            against the plain path.
7c. ssd_bwd, rglru_bwd, flash_d256_bwd
            the three backward kernels at the train shapes (S=4096): the
            SSD backward at Mamba-2 780M's widths and the RG-LRU backward at
            RecurrentGemma-9B's (each in bf16 and float32, with an initial
            state and a cotangent of the last state), the flash backward at
            head dim 256 at RecurrentGemma's attention (window 2048; bf16 on
            the tensor-core kernels, float32 on the FMA ones): every gradient
            against the plain version and against autograd through the plain
            forward within 1e-2 relative L2 in bf16 and 1e-5 in float32, two
            calls bit-equal; timed in bf16 against the plain version, the
            bound and, for flash, ``scaled_dot_product_attention``'s backward
            and the FMA kernels (``fma_ms``); each backward's passes' device
            ms and kernels a call from one profiled window
            (``ssd_bwd.passes``, ``rglru_bwd.passes``,
            ``flash_d256_bwd.passes``; bf16 at Mamba-2's widths runs the
            SSD tensor-core route, ``route``, which must be the
            ``SSD_BWD_TC_KERNELS`` once each and nothing else: the
            forward's state pass (the chunk states and the dual states in
            one launch), the two carries, the three wgmma row-tile passes,
            ddA and the head sum; the bf16 flash backward
            at 256 four passes: delta, the dK/dV partials and dQ on wgmma,
            the partials' sum; the RG-LRU backward one kernel).
8. serve_ssm, serve_hybrid
            the full Mamba-2 780M (48 layers) and the full
            RecurrentGemma-9B (38 layers), bf16, random weights from a
            seed, behind ``ElasticServer`` with the serve phase's requests
            and ``Shell.post(Grow)``, then ``prefill`` at S=32768, B=1,
            counting launches over exactly the serve and the prefill; the
            same on the plain path (token streams and port traffic equal;
            every block of the prefill within 2e-2 relative L2 of the plain
            path's on the same input; the end-to-end logits within 3 times
            a rounding-sized control of the same run); then a float32 copy
            cut to 2 layers (the hybrid to 3, one whole group): prefill
            logits and loss against the plain path, and prefill's token
            against ``ModelEngine``'s replay of
            the same 512-token prompt through ``decode_step``.
8b. train_ssm, train_hybrid
            ``make_train_step`` with AdamW on the full Mamba-2 780M (48
            layers) and on RecurrentGemma-9B cut to 2 of its 12 groups (6
            blocks), bf16, remat "dots", one ``train_4k`` batch cut to B=1
            (S=4096): step 1's loss and every gradient leaf under remat
            "nothing" equal "dots"'s bit for bit; 3 steps, losses finite
            and falling, the forward and backward kernels launched over
            exactly these steps (each block's backward once a step, the
            hybrid's flash on the tensor-core route); then a float32 copy cut
            to 2 layers (the hybrid to one group) at S=4096: loss and every
            gradient leaf on the kernels within 1e-4 of the leaf's largest
            value of the plain path.
8c. serve_encdec, train_encdec, serve_vlm
            Whisper-medium (24 + 24 layers, 16 heads of 64) whole and
            LLaVA-NeXT-34B at all 60 layers (68.8 GB of bf16 weights; its
            parameter count from ``n_params`` beside the bytes), bf16,
            random weights from the seed, behind ``ElasticServer`` with
            the serve phase's requests and ``Shell.post(Grow)``, then
            ``prefill`` at S=4096, B=1 (Whisper against 1,500 frames,
            LLaVA with 2,880 patches, both from N(0, 0.02)): launches
            counted over exactly the serve and the prefill, the prefill's
            flash launches by kind (causal, bidirectional, cross; all on
            the tensor-core route); the same on the plain path (token
            streams and port traffic equal, every block within 2e-2
            relative L2, the last-token logits within 2e-2 or else 3x the
            same run's one-ulp control, the line naming the limit that
            held).  The decode state's cross-attention cache stays zero,
            as in the JAX package, so served Whisper tokens do not depend
            on the audio.  ``train_encdec``: 3 AdamW steps (lr 1e-3) of
            the whole Whisper at S=4096 with 1,500 frames under remat
            "dots", the 3rd loss below the 1st, exactly 72 flash backward
            launches a step (24 encoder, 24 decoder, 24 cross), then a
            float32 copy cut to 2 + 2 layers: loss and every gradient leaf
            within 1e-4 of the leaf's largest value of the plain path.
            ``serve_vlm.train``: LLaVA cut to 2 of 60 layers (AdamW's
            moments of all 60 exceed the card), 3 steps at S=4096 with
            patches at lr 2e-5 (LLaVA-NeXT's published rate; 1e-3
            overshoots at this width on the plain path too), one flash
            backward a layer a step (D=128, G=7).
8c2. serve_dense.<arch>, train_dense.<arch>
            the dense family's other published configs at their widths,
            bf16, random weights from the seed: Qwen2.5-3B (36 layers, its
            QKV biases drawn from N(0, 0.02), both inits leaving them zero;
            tied head over 151,936 rows) and Granite-3-2B (40 layers, head
            dim 64) whole; Mixtral-8x22B cut to 8 of 56 layers (41 GB),
            its MoE on the crossbar kernels, prefilled at S=8192 so that
            its window of 4096 cuts half of the keys (the line prints the
            live (query, key) pairs beside the causal count); Command R+
            cut to 8 of 64 layers (G = 12; 31.5 GB with the tied 256000 x
            12288 embedding).  Each is served and prefilled as in 8c
            (prefill S=4096 but Mixtral-8x22B's; the same checks: tokens
            and port traffic, every block, the logits, causal flash
            launches one a layer, all ``tc``; the MoE's crossbar kernels
            launched; a MoE block is held by its halves, the attention
            half and the MoE half each on the same input within 2e-2, and
            as a whole within 2e-2 or else 3x the plain block's reading
            on its input moved by one bf16 ulp, since the top-2 routing
            flips some tokens' experts under any rounding difference) and
            trained as in 8c (3 AdamW steps at S=4096, lr
            1e-3, remat "dots"; one ``tc`` flash backward a layer a step;
            Mixtral-8x22B at 1 layer, its crossbar kernels launched).
            Command R+'s train cell (1 layer: 4.72 B parameters) runs only
            if ``dryrun.run_cell`` predicts that it fits; else its line
            says that it was not run.
8d. launch the launch tools (``repro_torch.launch``).  (a) ``dryrun.run_cell``
            on the ``card`` mesh at microbatches 1, on the meta device
            with no card (in three processes of their own started after
            the build, so that this host work runs beside the card
            phases; (e) too), for the cells of phases 6, 8b and 8c: the
            served Mixtral (2 layers) and the whole Mamba-2 780M trained
            at S=4096, B=1, LLaVA-NeXT-34B (60 layers) and Whisper-medium
            prefilled at S=4096; each record on its own line, then a
            table beside what the phase measured in this run: parameter
            and optimizer bytes equal to the bytes the phase allocated,
            each cell predicted to fit, the prefill cells' measured peak
            (``max_memory_allocated``) within 0.8-1.25 of the predicted,
            the train cells' ratio printed; Mixtral-8x7B at 32 layers and
            LLaVA-NeXT-34B at 60 trained at S=4096, B=1 predicted not to
            fit; the 8c2 cells too: each train cell (Command R+'s, if not
            run, predicted not to fit) and Command R+'s 8-layer prefill at
            S=4096, whose peak is held to the same band.  (c) the
            deprecated fixed-wave ``ServeLoop`` on a rebuilt served
            Mixtral (the same seed), 4 requests of 16 tokens,
            ``max_new=8``: tokens equal to the same loop on the plain path
            on the card, the crossbar kernels launched.  (d) one train
            step of that model (forward and backward, the kernel path)
            recorded by ``OpRecorder``: ``dense_routing_bytes`` 0 at the
            dense formulation's geometry (2,048 packets a group, 4 groups
            x 8 experts x 320 slots), the crossbar and flash kernels
            launched; the ``dense`` impl's MoE layer at ``moe_impls``'s
            shape, recorded alike, must show that tensor.  (e) ``train_4k``
            of Mixtral-8x7B (32 layers) and TinyLlama-1.1B on the ``pod``
            mesh: one device's FLOPs, bytes, collectives and peak (host
            work, its seconds printed).  Launches are counted over
            exactly (c) and (d) (``launches_by_path``: ``launch``).
9. paper_usecase
            the paper's experiments on the port's copy of the hardware
            model (Fig 5, §V-D, §V-E, Fig 6, Table II; model milliseconds
            and FPGA cycles, each beside the paper's value); the use case
            (multiplier -> Hamming(31,26) encoder -> decoder, 16 KB) on a
            ``Shell`` with 1, 2 and 3 free regions, placed modules on the
            card's kernels and ``ON_SERVER`` ones on the CPU, each output
            equal to ``ElasticUseCase.run_case(k).output``, then one tenant
            grown from 1 region to 3 without a rebuild (launches counted
            over exactly these runs); the three Hamming kernels bit-equal
            to their plain versions at 16 KB, 2^28 and 2^28 - 3 words,
            every single-bit error position, double-bit errors and several
            constants, timed at 2^28 words (the multiplier also in 10
            rounds alternating with ``torch.mul``, ``mul_rounds``: each
            side's quartiles and the rounds the multiplier won); then
            the single-source plan
            kernel through the deprecated ``crossbar_plan`` ->
            ``crossbar_dispatch`` -> ``crossbar_combine`` shims at the four
            shapes of ``tests/test_kernels.py``, the zero-packet round and
            out-of-range ``dst`` (launches counted over exactly these
            rounds), bit-equal to ``plan_ref``, timed at T = 2^20, S = 16
            (also by device time, kernels and memsets a call, and host
            time; it fails if that plan clears memory).

10. serve_harness
            ``ServeHarness`` + ``SeededEngine`` over an ``ElasticServer`` on
            the ``cuda`` fabric at ``benchmarks/serve_bench.py``'s shapes
            (read, not imported): 2,048 front-loaded streams through 1,024
            slots, ``max_new=48``, with the plan cache on and off, and
            2,048 heavy-tailed streams through 256 slots under a FailRegion
            / heal / Shrink / Grow script with the cache on.  Each report's
            integers and sha256 token digest, and the port traffic, equal
            the same run on the ``reference`` backend on the CPU; the digest
            is the same with the cache on and off; the storm's cache
            invalidations equal its posts; one plan signature
            (``fabric_retraces`` 1); one plan launch per cache miss, or per
            tick with an active slot with the cache off; the crossbar
            library loaded once.  Tick percentiles and tokens/s printed.
11. manager_scenarios
            ``run_scenario`` on the card (``fabric_backend="cuda"``):
            ``bursty``, ``production`` on a ``ServerPool`` of 4 servers over
            24 regions, ``adversarial`` under ``adversarial_policy()``,
            seed 0, 48 ticks, each ``to_json()`` equal to the same call on
            ``reference`` on the CPU; ``production`` recorded on the card
            and replayed through ``RecordedWorkload`` to the same trace;
            plan launches > 0 and the crossbar library loaded once.

12. sharded
            mesh expert parallelism, last: the ``moe_impls`` layer (T=4096
            as [4, 1024, d], capacity ``expert_capacity(4096)`` = 1280)
            through ``moe_forward_sharded`` on 4 ranks spawned over gloo,
            all on ``cuda:0`` (2 experts a rank; gloo stages each
            collective through host memory), each rank's packets moved by
            the scatter and combine kernels.  Rank 0 holds one forward and
            backward against ``moe_apply_sharded_reference`` on the card:
            integer stats (counts, drops, local and remote packets and
            their per-port splits) and the gathered plans equal, y and the
            gradients of x and of every parameter within 2e-2 relative L2;
            every rank holds the same output and gradients and launches
            its scatter and combine kernels (counted over that step).
            Then 2 timed steps (wall ms, and the collectives' share of it:
            four processes time-slice one card, so neither is a card
            collective's speed), a ``FailRegion`` posted to every rank's
            ``Shell`` (the next step re-routes as the oracle does, no new
            signature, one library load a rank), and rank 0 runs the layer
            over NCCL at world size 1 against the oracle at one shard.  A
            rank that fails or hangs (600 s) fails the phase with every
            failed rank's traceback.

13. tensor_parallel
            tensor parallelism and FSDP of ``DenseLM``
            (``models/parallel.py``) on 4 gloo ranks sharing ``cuda:0``,
            a (2, 2) ("data", "model") mesh: TinyLlama-1.1B whole (22
            layers, bf16) prefilled at B=16, S=2048, served by
            ``ServeLoop`` (16 slots x 8 tokens, every rank the same
            tokens) and trained 3 AdamW steps at B=16, S=2048 (the batch
            sharded over data; finite losses, the 3rd below the 1st);
            Mixtral-8x7B cut to 1 layer, its loss, gradients and one step
            at B=16, S=1024 with the crossbar plan, scatter and combine on
            every rank; a float32 TinyLlama at 2 layers on the plain path.
            Every rank launches the ``tc`` flash kernels and the crossbar
            kernels and loads each library once.  The parent then holds
            the unsharded results against the one-rank programs on the
            card: bf16 prefill logits within 2e-2 relative L2, Mixtral's
            loss and gradients within 2e-2, the float32 loss and
            gradient leaves within 1e-4 of the leaf's largest value; and
            the TinyLlama train step over NCCL on a (1, 1) mesh in this
            process, its loss equal to the one-rank step's bit for bit.
            Each rank prints step wall ms, the collectives' share, calls
            and bytes (``collectives.timing``, steps 2 and 3) and its peak.
14. tensor_parallel_families
            the same mesh and ranks for the other families: Mamba-2 780M
            whole (48 layers), RecurrentGemma-9B cut to 2 groups and
            Whisper-medium whole, bf16, random weights from the seed, one
            prefill and one AdamW step each at B=1, S=4096 on the SSD,
            RG-LRU and flash kernels (the step under
            ``collectives.timing``: wall, share, calls, bytes; each
            rank's peak); then a short bf16 program of each (2 layers;
            the hybrid 1 group; Whisper 2 + 2) on the kernels, its
            prefill, loss and gradients, and its float32 control on the
            plain path.  The parent holds them against the one-rank
            programs: full-depth last-token logits within 2e-2 relative
            L2 or 3x the same run's rounding control (as serve_ssm holds
            them) and the loss within 1e-3; the short program's logits and
            every gradient leaf within their limits (TPF_SHORT_*_REL,
            relative L2) and its loss within 1e-3; the float32 loss and
            gradient leaves within 1e-4 of the leaf's largest value, the
            worst leaf named beside its one-ulp sensitivity; runs a
            Mamba-2 step over NCCL at world size 1 (its loss bit-equal to
            no mesh) and the three configs' ``train_4k`` dry runs on the
            pod.  It fails if a rank launches none of a family's kernels
            (full or short) or an FMA flash kernel in bf16, if a library
            loads twice, or if the ranks' peaks sum over 76 GB.
15. examples
            ``python -m repro_torch.examples.<name>`` in processes of their
            own, started together: quickstart, paper_usecase, elastic_serving (and
            ``--steady-state``), moe_training at its defaults (300 steps,
            its convergence asserted) and ``--sharded`` (4 gloo ranks on
            ``cuda:0``): each exits 0, prints its checks' lines and loads
            no library twice (``launches_by_path``: ``examples``, the
            modules' own processes).

``--profile`` adds a phase after serving and one after the train steps:
``torch.profiler`` over 8 warm decode steps of the served engine and over
one more train step, one over each recurrent model's S=32768 prefill and
one over one more step of each recurrent train cell, one over each S=4096
prefill and train step of phases 8c and 8c2; device time by
kernel, the device's idle share, and Chrome traces in ``build/profile/``.  ``--seed N`` (default 0) draws every input, weight
and prompt from another seed.

The last line is ``{"ok": true, "device": {...}}``; any failure raises and
exits non-zero before it.  Imports nothing of JAX.
"""
from __future__ import annotations

import atexit
import dataclasses
import functools
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0
GB = 1 << 30


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median time of one call of ``fn`` over ``reps`` runs, CUDA events."""
    from repro_torch.kernels.timing import event_ms
    return event_ms(fn, reps=reps, warmup=warmup)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def roofline():
    """``repro_torch.launch.roofline``: the H100's peaks (``HBM_BW``,
    ``PEAK_FLOPS`` for bf16 on the tensor cores, ``PEAK_FLOPS_F32``) and
    ``bound``."""
    from repro_torch.launch import roofline as r
    return r


def bound(n_bytes: float, n_ops: float, ops_per_s=None):
    """``roofline().bound``: (ms, "bytes" or "operations"), the operations
    at the float32 peak unless ``ops_per_s`` says."""
    r = roofline()
    return r.bound(n_bytes, n_ops,
                   r.PEAK_FLOPS_F32 if ops_per_s is None else ops_per_s)


# ----------------------------------------------------------------------
# kernel inputs: real plans over seeded random registers
# ----------------------------------------------------------------------
def random_registers(S: int, capacity: int, gen: torch.Generator, *,
                     holes: bool = True):
    from repro_torch.core.registers import CrossbarRegisters
    regs = CrossbarRegisters.create(S, capacity=capacity, device="cuda")
    if not holes:
        return regs
    dev = "cuda"
    allowed = torch.rand((S, S), generator=gen, device=dev) > 0.15
    quota = torch.randint(0, 4 * capacity, (S, S), generator=gen, device=dev,
                          dtype=torch.int32)
    quota = torch.where(torch.rand((S, S), generator=gen, device=dev) > 0.5,
                        quota, 0)
    reset = torch.zeros((S,), dtype=torch.bool, device=dev)
    reset[int(torch.randint(0, S, (1,), generator=gen, device=dev))] = True
    return regs.write(allowed=allowed, quota=quota, reset=reset)


def random_packets(T: int, S: int, n_src: int, gen: torch.Generator,
                   pad: float = 0.05):
    dst = torch.randint(0, S, (T,), generator=gen, device="cuda",
                        dtype=torch.int32)
    dst = torch.where(torch.rand((T,), generator=gen, device="cuda") < pad,
                      -1, dst).to(torch.int32)
    src = torch.randint(0, n_src, (T,), generator=gen, device="cuda",
                        dtype=torch.int32)
    return dst, src


class Case:
    """One shape the kernels are held to: packets, registers, a plan."""

    def __init__(self, name, T, S, C, D, dtype, n_src, gen, holes=True):
        from repro_torch.fabric.backends import ReferenceBackend
        self.name, self.T, self.S, self.C, self.D = name, T, S, C, D
        self.dtype = dtype
        self.regs = random_registers(S, C, gen, holes=holes)
        self.dst, self.src = random_packets(T, S, n_src, gen,
                                            pad=0.05 if holes else 0.0)
        self.allowed = (self.regs.allowed & ~self.regs.reset[:, None]
                        & ~self.regs.reset[None, :]).to(torch.int32)
        self.quota_sd = self.regs.quota.T            # a strided view on purpose
        plan = ReferenceBackend().plan(self.dst, self.src, self.regs)
        self.keep = plan.keep.to(torch.int32)
        self.slot = plan.slot
        self.x = torch.randn((T, D), generator=gen, device="cuda").to(dtype)
        self.y = torch.randn((S, C, D), generator=gen, device="cuda").to(dtype)
        self.w = torch.rand((T,), generator=gen, device="cuda")

    def check(self):
        """Kernel vs plain version, bit-equal; also the backend's whole plan
        (kernel + closed-form slots) vs the reference plan.  Returns each
        kernel's max abs difference from its plain version."""
        from repro_torch.fabric.backends import CudaBackend, ReferenceBackend
        from repro_torch.fabric.interface import KernelMode
        from repro_torch.kernels.crossbar_dispatch import kernel as K, ref
        pk = K.plan_multi(self.dst, self.src, self.allowed, self.quota_sd,
                          mode=KernelMode.CUDA)
        pr = ref.plan_multi_ref(self.dst, self.src, self.allowed,
                                self.quota_sd)
        sk = K.scatter(self.x, self.dst, self.keep, self.slot,
                       n_ports=self.S, capacity=self.C, mode=KernelMode.CUDA)
        sr = ref.scatter_ref(self.x, self.dst, self.keep, self.slot, self.S,
                             self.C)
        ck = K.combine(self.y, self.dst, self.keep, self.slot, self.w,
                       mode=KernelMode.CUDA)
        cr = ref.combine_ref(self.y, self.dst, self.keep, self.slot, self.w)
        be = CudaBackend(kernel_mode=KernelMode.CUDA)
        plan_k = be.plan(self.dst, self.src, self.regs)
        plan_f = K.plan_fabric(self.dst, self.src, self.regs.allowed,
                               self.regs.reset, self.regs.quota,
                               self.regs.capacity, mode=KernelMode.CUDA)
        plan_r = ReferenceBackend().plan(self.dst, self.src, self.regs)
        torch.cuda.synchronize()
        errs = {"plan_multi": max(max_abs_err(a, b) for a, b in zip(pk, pr)),
                "scatter": max_abs_err(sk, sr),
                "combine": max_abs_err(ck, cr)}
        res = {
            "plan_multi": all(torch.equal(a, b) for a, b in zip(pk, pr)),
            "scatter": torch.equal(sk, sr),
            "combine": torch.equal(ck, cr),
            "backend_plan": all(
                torch.equal(getattr(plan_k, f.name), getattr(plan_r, f.name))
                for f in dataclasses.fields(plan_r)),
            "plan_fabric": all(
                torch.equal(getattr(plan_f, f.name), getattr(plan_r, f.name))
                for f in dataclasses.fields(plan_r)),
        }
        emit("kernels.check", case=self.name, T=self.T, S=self.S, C=self.C,
             D=self.D, dtype=str(self.dtype).replace("torch.", ""),
             granted=int(self.keep.sum()), max_abs_err=errs, **res)
        if not all(res.values()):
            raise AssertionError(f"kernel mismatch on {self.name}: {res}")
        return errs

    def timings(self):
        """(kernel, plain, library, bound, bound_by) per kernel, in ms; for
        scatter and combine also the device ms (``torch.profiler``, 20
        calls, with kernels and memsets per call) and host us per call
        (1,000 calls, card busy) of the kernel and of the library call;
        for ``plan_multi`` the same of its call and, as ``plan_fabric`` and
        ``backend_plan``, of the fabric's plan entry and of
        ``CudaBackend.plan`` around it."""
        from repro_torch.fabric.backends import CudaBackend
        from repro_torch.fabric.interface import KernelMode
        from repro_torch.kernels.crossbar_dispatch import kernel as K, ref
        from repro_torch.kernels.timing import device_profile, host_us
        T, S, C, D = self.T, self.S, self.C, self.D
        es = self.x.element_size()
        kept = int(self.keep.sum())
        cuda = KernelMode.CUDA
        out = {}
        b, by = bound(5 * T * 4 + 3 * S * S * 4, 0)
        plan_multi = lambda: K.plan_multi(self.dst, self.src, self.allowed,
                                          self.quota_sd, mode=cuda)
        out["plan_multi"] = dict(
            ms=time_ms(plan_multi),
            plain_ms=time_ms(lambda: ref.plan_multi_ref(
                self.dst, self.src, self.allowed, self.quota_sd)),
            library_ms=None, bound_ms=b, bound_by=by)
        regs = self.regs
        backend = CudaBackend(kernel_mode=cuda)
        plans = {
            "plan_multi": plan_multi,
            "plan_fabric": lambda: K.plan_fabric(
                self.dst, self.src, regs.allowed, regs.reset, regs.quota,
                regs.capacity, mode=cuda),
            "backend_plan": lambda: backend.plan(self.dst, self.src, regs),
        }
        for name, fn in plans.items():
            prof = device_profile(fn)
            out.setdefault(name, {}).update(
                device_ms=prof["device_ms"], kernels_per_call=prof["kernels"],
                memsets_per_call=prof["memsets"], host_us=host_us(fn))
            if name != "plan_multi":
                out[name]["ms"] = time_ms(fn)

        ok = ((self.keep > 0) & (self.dst >= 0) & (self.slot < C))
        trash = S * C
        addr = torch.where(ok, self.dst * C + self.slot, trash).long()
        flat = torch.zeros((S * C + 1, D), dtype=self.dtype, device="cuda")
        b, by = bound(kept * D * es + 3 * T * 4 + S * C * D * es, 0)
        out["scatter"] = dict(
            ms=time_ms(lambda: K.scatter(self.x, self.dst, self.keep,
                                         self.slot, n_ports=S, capacity=C,
                                         mode=cuda)),
            plain_ms=time_ms(lambda: ref.scatter_ref(
                self.x, self.dst, self.keep, self.slot, S, C)),
            library_ms=time_ms(lambda: flat.index_copy_(0, addr, self.x)),
            bound_ms=b, bound_by=by)

        y_flat = self.y.reshape(S * C, D)
        w_lib = (self.w * ok).to(self.dtype)
        cidx = torch.where(ok, addr, 0)
        b, by = bound(kept * D * es + 4 * T * 4 + T * D * es, T * D)
        out["combine"] = dict(
            ms=time_ms(lambda: K.combine(self.y, self.dst, self.keep,
                                         self.slot, self.w, mode=cuda)),
            plain_ms=time_ms(lambda: ref.combine_ref(
                self.y, self.dst, self.keep, self.slot, self.w)),
            library_ms=time_ms(
                lambda: y_flat.index_select(0, cidx) * w_lib[:, None]),
            bound_ms=b, bound_by=by)
        calls = {
            "scatter": (lambda: K.scatter(self.x, self.dst, self.keep,
                                          self.slot, n_ports=S, capacity=C,
                                          mode=cuda),
                        lambda: flat.index_copy_(0, addr, self.x)),
            "combine": (lambda: K.combine(self.y, self.dst, self.keep,
                                          self.slot, self.w, mode=cuda),
                        lambda: y_flat.index_select(0, cidx)
                        * w_lib[:, None]),
        }
        for name, (kernel, library) in calls.items():
            k, lib = device_profile(kernel), device_profile(library)
            out[name].update(
                device_ms=k["device_ms"], kernels_per_call=k["kernels"],
                memsets_per_call=k["memsets"], host_us=host_us(kernel),
                library_device_ms=lib["device_ms"],
                library_host_us=host_us(library))
        emit("kernels.time", case=self.name, T=T, S=S, C=C, D=D,
             dtype=str(self.dtype).replace("torch.", ""), **out)
        return out


# ----------------------------------------------------------------------
# flash attention: forward and backward against the plain versions
# ----------------------------------------------------------------------
# Each case is held three ways, with limits by dtype:
# - every element of o and lse (forward) and of dq, dk, dv (backward)
#   within FLASH_TOL, absolute and relative: the JAX package's own forward
#   tolerance and 1e-4 / 5e-2 backward;
# - o, dq, dk and dv each within FLASH_REL_L2 relative L2 of the plain
#   version: a wrong mask or a skipped 64-key tile moves it by some 1e-1
#   at these shapes, while bf16 rounding of the output moves it by some
#   1e-3 (PERF.md gives the readings);
# - the row log-sum-exp (float32 in both) within FLASH_LSE_ABS absolute:
#   one skipped 64-key tile moves it by about 64/4096 = 1.6e-2.
FLASH_TOL = {torch.float32: (2e-5, 1e-4), torch.bfloat16: (3e-2, 5e-2)}
FLASH_REL_L2 = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
FLASH_LSE_ABS = {torch.float32: 2e-5, torch.bfloat16: 1e-3}
PLAIN_KV_HEADS = 2     # kv heads per plain-version call: bounds its memory
# The four timed bf16 shapes are also read against a float32 reference
# (the plain version on the same inputs cast to float32): relative L2 of o,
# dq, dk, dv and the largest lse error, of the kernels and of the bf16
# plain version.  The kernels' readings are held within FLASH_F32_LIMIT, 1.25x
# what the mma.sync kernels that took bf16 at head dims 64 and 128 before
# the wgmma ones read on the same inputs (PERF.md, section 6): a kernel
# whose gradients lean away from the exact ones, which FLASH_REL_L2 does
# not see, fails here.
FLASH_F32_QTYS = ("o", "lse", "dq", "dk", "dv")
FLASH_F32_FACTOR = 1.25
FLASH_F32_MMA_SYNC = {   # the mma.sync kernels' readings (PERF.md, section 6)
    "train": {"o": 0.002053706208243966, "lse": 1.9073486328125e-06,
              "dq": 0.0024603677447885275, "dk": 0.0024560189340263605,
              "dv": 0.002313717734068632},
    "llava_g7": {"o": 0.0020510966423898935, "lse": 1.9073486328125e-06,
                 "dq": 0.002458361443132162, "dk": 0.002441774820908904,
                 "dv": 0.002314517740160227},
    "whisper_encoder": {"o": 0.002232826082035899,
                        "lse": 1.430511474609375e-06,
                        "dq": 0.0023874936159700155,
                        "dk": 0.0023523904383182526,
                        "dv": 0.0023488057777285576},
    "whisper_cross": {"o": 0.0022483346983790398,
                      "lse": 1.430511474609375e-06,
                      "dq": 0.0023912519682198763,
                      "dk": 0.002348032547160983,
                      "dv": 0.0023488225415349007},
}
FLASH_F32_LIMIT = {case: {q: FLASH_F32_FACTOR * r for q, r in row.items()}
                   for case, row in FLASH_F32_MMA_SYNC.items()}


def flash_bwd_tc_kernels(D: int) -> tuple:
    """The kernels of one bf16 flash backward at head dim 64 or 128, once
    each: the row sums of dO * O, the dK/dV pass and the dQ pass."""
    return ("delta_kernel<__nv_bfloat16>", f"tc::dkdv_ws_kernel<{D}>",
            f"tc::dq_ws_kernel<{D}>")


def flash_live_tiles(Sq, Sk, causal, window, q_offset, dtype, D) -> int:
    """(q tile, k tile) pairs the forward kernel of the route that takes
    (dtype, D) visits per (batch, head): the kernels' own tile skip (none
    above the causal diagonal, none wholly outside the window)."""
    from repro_torch.kernels.flash_attention import kernel as FK
    BLOCK_Q, BLOCK_K = FK.fwd_tile(dtype, D)
    n = 0
    for q0 in range(0, Sq, BLOCK_Q):
        q_last = q_offset + min(q0 + BLOCK_Q, Sq) - 1
        end = -(-Sk // BLOCK_K)
        if causal:
            end = min(end, q_last // BLOCK_K + 1)
        begin = 0
        if window is not None:
            begin = max(q_offset + q0 - window + 1, 0) // BLOCK_K
        n += max(0, end - begin)
    return n


def flash_live_pairs(Sq, Sk, causal, window, q_offset) -> int:
    """Unmasked (query, key) pairs per (batch, head): the work the function
    needs, which the bounds count (the kernels also compute the masked part
    of the diagonal and window-edge tiles they visit)."""
    q_pos = q_offset + np.arange(Sq, dtype=np.int64)
    hi = np.minimum(q_pos + 1, Sk) if causal else np.full(Sq, Sk)
    lo = np.maximum(q_pos - window + 1, 0) if window is not None else 0
    return int(np.maximum(hi - lo, 0).sum())


def within(a: torch.Tensor, b: torch.Tensor, tol: float) -> bool:
    return bool(torch.isclose(a.double(), b.double(), rtol=tol,
                              atol=tol).all())


def _chunks(t: torch.Tensor):
    """``t``'s elements 2^24 at a time: in float64 the sharded phase's
    expert-weight gradients (939 M elements) would take 7.5 GB at once."""
    return t.reshape(-1).split(1 << 24)


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b||, summed in float64 chunk by chunk."""
    num = den = 0.0
    for x, y in zip(_chunks(a), _chunks(b)):
        x, y = x.double(), y.double()
        num += float(((x - y) ** 2).sum())
        den += float((y ** 2).sum())
    # as a tensor division: a zero ||b|| gives inf or nan, not an exception
    return float(torch.tensor(num).sqrt() / torch.tensor(den).sqrt())


def lse_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b|, rows that are -inf in both (no live key) counting
    as equal."""
    a, b = a.double(), b.double()
    return float(torch.where(a == b, 0.0, a - b).abs().max())


def f32_readings(got, exact) -> dict:
    """(o, lse, dq, dk, dv) against the float32 reference ``exact``:
    relative L2 of each tensor, the largest error of the lse."""
    out = {n: rel_l2(a, b) for n, a, b in zip(FLASH_F32_QTYS, got, exact)}
    out["lse"] = lse_abs_err(got[1], exact[1])
    return out


class FlashCase:
    """One shape the flash kernels are held to."""

    def __init__(self, name, B, Sq, Sk, H, Kv, D, dtype, causal, window,
                 gen):
        self.name, self.dtype = name, dtype
        q_offset = max(Sk - Sq, 0)   # more queries than keys: cross only
        self.kw = dict(causal=causal, window=window, q_offset=q_offset)
        mk = lambda *shape: torch.randn(shape, generator=gen,
                                        device="cuda").to(dtype)
        self.q, self.k, self.v = mk(B, Sq, H, D), mk(B, Sk, Kv, D), \
            mk(B, Sk, Kv, D)
        self.do = mk(B, Sq, H, D)
        self.tiles = B * H * flash_live_tiles(Sq, Sk, causal, window,
                                              q_offset, dtype, D)
        self.pairs = B * H * flash_live_pairs(Sq, Sk, causal, window,
                                              q_offset)
        self.shape = dict(B=B, Sq=Sq, Sk=Sk, H=H, Kv=Kv, D=D,
                          dtype=str(dtype).replace("torch.", ""),
                          causal=causal, window=window, q_offset=q_offset)

    def plain(self, dtype=None):
        """The plain versions, a few kv heads per call (every head is
        independent, so this is the same function with less memory); with
        ``dtype``, on the inputs cast to it."""
        from repro_torch.kernels.flash_attention import ref
        q, k, v, do = (t if dtype is None else t.to(dtype)
                       for t in (self.q, self.k, self.v, self.do))
        G = q.shape[2] // k.shape[2]
        parts = []
        for j in range(0, k.shape[2], PLAIN_KV_HEADS):
            hq = slice(j * G, (j + PLAIN_KV_HEADS) * G)
            hk = slice(j, j + PLAIN_KV_HEADS)
            o, lse = ref.attention_fwd_ref(q[:, :, hq], k[:, :, hk],
                                           v[:, :, hk], **self.kw)
            grads = ref.attention_bwd_ref(q[:, :, hq], k[:, :, hk],
                                          v[:, :, hk], do[:, :, hq],
                                          **self.kw)
            parts.append((o, lse, *grads))
        cat = lambda i, dim: torch.cat([p[i] for p in parts], dim=dim)
        return cat(0, 2), cat(1, 1), cat(2, 2), cat(3, 2), cat(4, 2)

    def check(self):
        """Kernel vs plain version; returns (forward, backward) max abs
        errors."""
        from repro_torch.fabric.interface import KernelMode
        from repro_torch.kernels.flash_attention import kernel as FK
        cuda = KernelMode.CUDA
        o, lse = FK.flash_fwd(self.q, self.k, self.v, mode=cuda, **self.kw)
        grads = FK.flash_bwd(self.q, self.k, self.v, o, lse, self.do,
                             mode=cuda, **self.kw)
        o_r, lse_r, *grads_r = self.plain()
        torch.cuda.synchronize()
        f_tol, b_tol = FLASH_TOL[self.dtype]
        rel_tol, lse_tol = FLASH_REL_L2[self.dtype], FLASH_LSE_ABS[self.dtype]
        err_f = max(max_abs_err(o, o_r), lse_abs_err(lse, lse_r))
        err_b = max(max_abs_err(a, b) for a, b in zip(grads, grads_r))
        rel = {"o": rel_l2(o, o_r), **{f"d{n}": rel_l2(a, b) for n, a, b
                                       in zip("qkv", grads, grads_r)}}
        lse_err = lse_abs_err(lse, lse_r)
        res = {"forward": (within(o, o_r, f_tol) and within(lse, lse_r, f_tol)
                           and rel["o"] <= rel_tol and lse_err <= lse_tol),
               "backward": all(within(a, b, b_tol)
                               for a, b in zip(grads, grads_r))
               and all(rel[f"d{n}"] <= rel_tol for n in "qkv")}
        f32 = {}
        if self.name in FLASH_F32_LIMIT:
            exact = self.plain(torch.float32)
            f32 = {"kernel": f32_readings((o, lse, *grads), exact),
                   "plain": f32_readings((o_r, lse_r, *grads_r), exact),
                   "limit": FLASH_F32_LIMIT[self.name]}
            del exact
            res["float32_ref"] = all(f32["kernel"][n] <= f32["limit"][n]
                                     for n in FLASH_F32_QTYS)
        emit("flash.check", case=self.name, **self.shape,
             live_tiles=self.tiles, live_pairs=self.pairs, tol={"forward": f_tol, "backward": b_tol,
                                         "rel_l2": rel_tol, "lse": lse_tol},
             max_abs_err={"forward": err_f, "backward": err_b},
             rel_l2=rel, lse_abs_err=lse_err, f32=f32, **res)
        if not all(res.values()):
            raise AssertionError(f"flash kernel mismatch on {self.name}: "
                                 f"{res}")
        return err_f, err_b

    def timings(self):
        """(kernel, plain, library, bound) ms for forward and backward; the
        library call is ``scaled_dot_product_attention`` (GQA, causal or
        not as the case) in its head-major layout, the same function where
        the window is no narrower than the keys; where the window cuts
        keys, the memory-efficient backend with the window as a boolean
        mask and the kv heads repeated, as ``flash_d256_phase`` times it.
        For
        bfloat16 also ``fma_ms``: the float32 FMA kernels, which bfloat16
        took before the tensor-core kernels, on the same inputs."""
        from repro_torch.fabric.interface import KernelMode
        from repro_torch.kernels.flash_attention import kernel as FK
        from repro_torch.kernels.flash_attention import ref
        F = torch.nn.functional
        cuda = KernelMode.CUDA
        q, k, v, do = self.q, self.k, self.v, self.do
        B, Sq, H, D = q.shape
        es = q.element_size()
        rate = roofline().PEAK_FLOPS if self.dtype == torch.bfloat16 \
            else roofline().PEAK_FLOPS_F32
        fwd_ops = 4 * D * self.pairs                 # QK^T and PV
        io = (2 * q.numel() + k.numel() + v.numel()) * es
        o, lse = FK.flash_fwd(q, k, v, mode=cuda, **self.kw)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = ref.attention_ref(*leaves, **self.kw)
        causal, window = self.kw["causal"], self.kw["window"]
        cuts = window is not None and window < Sq + self.kw["q_offset"]
        G = H // k.shape[2]
        hm = [(t.repeat_interleave(G, dim=2) if cuts and t is not q else t)
              .transpose(1, 2).contiguous().requires_grad_()
              for t in (q, k, v)]
        if cuts:
            from torch.nn.attention import SDPBackend, sdpa_kernel
            q_pos = self.kw["q_offset"] + torch.arange(Sq, device="cuda")
            k_pos = torch.arange(k.shape[1], device="cuda")
            mask = k_pos[None, :] > q_pos[:, None] - window
            if causal:
                mask &= k_pos[None, :] <= q_pos[:, None]

            def sdpa(*ts):
                with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                    return F.scaled_dot_product_attention(*ts,
                                                          attn_mask=mask)
        else:
            def sdpa(*ts):
                return F.scaled_dot_product_attention(*ts, is_causal=causal,
                                                      enable_gqa=True)
        lib_out = sdpa(*hm)
        do_hm = do.transpose(1, 2).contiguous()
        out_f = {}
        b, by = bound(io + B * H * Sq * 4, fwd_ops, rate)
        out_f["flash_fwd"] = dict(
            ms=time_ms(lambda: FK.flash_fwd(q, k, v, mode=cuda, **self.kw),
                       reps=10),
            plain_ms=time_ms(lambda: ref.attention_fwd_ref(q, k, v,
                                                           **self.kw),
                             reps=5),
            library_ms=time_ms(lambda: sdpa(*[t.detach() for t in hm]),
                               reps=10),
            bound_ms=b, bound_by=by)
        if self.dtype == torch.bfloat16:
            out_f["flash_fwd"]["fma_ms"] = time_ms(
                lambda: FK.launch_fwd(q, k, v, kernel="fma", **self.kw),
                reps=3)
        # backward reads q, k, v, o, dO, lse and writes dq, dk, dv; it
        # needs S = QK^T, dP = dO V^T, dV, dK and dQ: 2.5x the forward
        b, by = bound(2 * io + B * H * Sq * 4, 2.5 * fwd_ops, rate)
        out_f["flash_bwd"] = dict(
            ms=time_ms(lambda: FK.flash_bwd(q, k, v, o, lse, do, mode=cuda,
                                            **self.kw), reps=10),
            plain_ms=time_ms(lambda: torch.autograd.grad(
                out, leaves, do, retain_graph=True), reps=5),
            library_ms=time_ms(lambda: torch.autograd.grad(
                lib_out, hm, do_hm, retain_graph=True), reps=10),
            bound_ms=b, bound_by=by)
        if self.dtype == torch.bfloat16:
            out_f["flash_bwd"]["fma_ms"] = time_ms(
                lambda: FK.launch_bwd(q, k, v, o, lse, do, kernel="fma",
                                      **self.kw), reps=3)
        for t in out_f.values():
            t["library_factor"] = t["ms"] / t["library_ms"]
            t["bound_share"] = t["bound_ms"] / t["ms"]
            t["library"] = ("efficient backend, boolean window mask" if cuts
                            else "flash-capable, enable_gqa")
        if self.dtype == torch.bfloat16 and D in FK.WS_BWD_HEAD_DIMS:
            t = out_f["flash_bwd"]
            _passes("flash_bwd", t, lambda: FK.flash_bwd(
                q, k, v, o, lse, do, mode=cuda, **self.kw), case=self.name)
            launched = sorted(r["name"] for r in t.pop("passes"))
            want = sorted(flash_bwd_tc_kernels(D))
            if launched != want or t["kernels_per_call"] != len(want):
                raise AssertionError(
                    f"the bf16 flash backward at {self.name} launched "
                    f"{launched} ({t['kernels_per_call']} a call), not {want} "
                    f"once each")
        emit("flash.time", case=self.name, **self.shape, **out_f)
        return out_f


# the shapes timed beside the train shape (the kernels line's ``shapes``)
FLASH_TIMED_SHAPES = ("whisper_encoder", "whisper_cross", "llava_g7",
                      "command_r_g12", "mixtral22_g6")


def flash_phase():
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 2)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        FlashCase("train", 1, 4096, 4096, 32, 8, 128, bf16, True, 4096, gen),
        FlashCase("banded", 1, 8192, 8192, 32, 8, 128, bf16, True, 4096,
                  gen),
        FlashCase("ragged", 1, 4001, 4001, 32, 8, 128, bf16, True, 4096,
                  gen),
        FlashCase("continuation", 1, 512, 4096, 32, 8, 128, bf16, True,
                  4096, gen),
        FlashCase("noncausal_f32", 1, 1024, 1024, 16, 4, 64, f32, False,
                  None, gen),
        FlashCase("d64", 1, 2048, 2048, 16, 4, 64, bf16, True, None, gen),
        FlashCase("small_window", 1, 2000, 2000, 32, 8, 128, bf16, True, 48,
                  gen),
        # the encoder-decoder's and the vlm's prefill and train shapes
        FlashCase("whisper_encoder", 1, 1500, 1500, 16, 16, 64, bf16, False,
                  None, gen),
        FlashCase("whisper_cross", 1, ENCDEC_SEQ, 1500, 16, 16, 64, bf16,
                  False, None, gen),
        FlashCase("llava_g7", 1, VLM_SEQ, VLM_SEQ, 56, 8, 128, bf16, True,
                  None, gen),
        # Command R+'s prefill (G = 12) and Mixtral-8x22B's at S=8192, whose
        # window of 4096 cuts half of the keys (G = 6)
        FlashCase("command_r_g12", 1, TRAIN_SEQ, TRAIN_SEQ, 96, 8, 128, bf16,
                  True, None, gen),
        FlashCase("mixtral22_g6", 1, 2 * TRAIN_SEQ, 2 * TRAIN_SEQ, 48, 8,
                  128, bf16, True, TRAIN_SEQ, gen),
    ]
    errs = [c.check() for c in cases]
    times = cases[0].timings()
    times["shapes"] = {c.name: {**c.shape, **c.timings()}
                       for c in cases if c.name in FLASH_TIMED_SHAPES}
    err = {"flash_fwd": max(e[0] for e in errs),
           "flash_bwd": max(e[1] for e in errs)}
    return err, times


# ----------------------------------------------------------------------
# the served path
# ----------------------------------------------------------------------
N_SLOTS = 4
PROMPT_LEN = 16
MAX_NEW = 8


def serving_config():
    """The served Mixtral: 2 of 32 layers, bf16, the MoE on the crossbar
    kernels; the train phase on it keeps every activation (remat
    "nothing"), as it has since it began, and ``train_loop`` runs remat."""
    from repro_torch.configs import get_config
    cfg = get_config("mixtral_8x7b")
    return dataclasses.replace(
        cfg, n_layers=2, dtype="bfloat16", remat="nothing",
        moe=dataclasses.replace(cfg.moe, dispatch="cuda_kernel"))


def serve(engine, fabric_backend: str, prompts):
    """Serve the 4 requests: 2 at tick 0, then ``Shell.post(Grow)`` after
    4 ticks and 2 more.  Returns (server, shell, wall seconds, ticks)."""
    from repro_torch.core.elastic import Region
    from repro_torch.core.module import ModuleFootprint
    from repro_torch.shell import Grow, Shell, Shrink
    from repro_torch.shell.server import ElasticServer, StreamRequest
    shell = Shell([Region(rid=i, n_chips=8, hbm_bytes=80 * GB)
                   for i in range(2)])
    shell.submit("mixtral", [ModuleFootprint(7 * GB, 2 * 3.2e9, 8192)],
                 app_id=0)
    shell.post(Shrink("mixtral", 0))        # starts on the host port
    server = ElasticServer(shell, n_slots=N_SLOTS,
                           fabric_backend=fabric_backend)
    server.register_engine(0, engine)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for p in prompts[:2]:
        server.submit(StreamRequest(app_id=0, prompt=p, max_new=MAX_NEW))
    for _ in range(4):
        server.step()
    shell.post(Grow("mixtral"))             # re-route: next admissions -> port 1
    for p in prompts[2:]:
        server.submit(StreamRequest(app_id=0, prompt=p, max_new=MAX_NEW))
    server.run()
    torch.cuda.synchronize()
    return server, shell, time.perf_counter() - t0


# ----------------------------------------------------------------------
# the train path
# ----------------------------------------------------------------------
TRAIN_SEQ = 4096        # train_4k's sequence length; batch cut 256 -> 1
TRAIN_STEPS = 3
TRAIN_LR = 1e-3         # constant; AdamW's other settings are its defaults
PREFILL_REL = 2e-2      # bf16 prefill logits: relative L2, kernel vs plain
F32_SEQ = 1024
F32_REL = 1e-4          # float32 loss and each gradient leaf, see f32_check
SERVE_KERNELS = ("plan_multi", "scatter", "combine")
TRAIN_KERNELS = SERVE_KERNELS + ("flash_fwd", "flash_bwd")
# the flash route each type must take: bfloat16 on the tensor-core kernels,
# float32 on the FMA ones, and no launch on the other route
FLASH_ROUTE = {"bfloat16": "tc", "float32": "fma"}


def check_flash_route(launches, dtype: str, what: str,
                      kernels=("flash_fwd", "flash_bwd")) -> None:
    """Each of ``kernels`` (the counts of ``FK.launch_counts``) ran on
    ``dtype``'s route and never on the other."""
    want = FLASH_ROUTE[dtype]
    other = ({"tc", "fma"} - {want}).pop()
    if not all(launches[f"{k}_{want}"] > 0 for k in kernels) \
            or any(launches[f"{k}_{other}"] for k in kernels):
        raise AssertionError(f"{what} ({dtype}) did not take only the "
                             f"{want} flash kernels: {launches}")


def _kernel_modules():
    from repro_torch.kernels.crossbar_dispatch import kernel as K
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.hamming import kernel as HK
    from repro_torch.kernels.rglru import kernel as RK
    from repro_torch.kernels.ssd import kernel as SK
    return FK, K, SK, RK, HK


def _counts():
    """Launches of every kernel since the last ``_reset_counts``."""
    return {k: v for m in _kernel_modules()
            for k, v in m.launch_counts().items()}


def _reset_counts():
    for m in _kernel_modules():
        m.reset_launch_counts()


def train_shape():
    """``train_4k`` cut to batch 1: the train phase's cell."""
    from repro_torch.models.config import ShapeConfig
    return ShapeConfig("train_4k_b1", TRAIN_SEQ, 1, "train")


# what a phase measured that the launch phase's dry runs are held against:
# phase -> {"max_memory_allocated", "param_bytes", "opt_state_bytes"}
MEASURED = {}


def train_phase(engine, smi):
    """3 steps of ``build_step``'s train step (``make_train_step`` with
    AdamW, built for ``train_shape()`` on the card mesh) on the served
    model's parameters (the engine's own bf16 tensors, updated in place),
    then the prefill check.  Returns the launches of the steps and the
    step timings."""
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.launch.steps import build_step
    from repro_torch.models.common import tree_nbytes
    from repro_torch.optim.adamw import AdamW
    model, params = engine.model, engine.params
    cfg = model.cfg
    batch = {k: torch.from_numpy(v).cuda() for k, v in synthetic_batch(
        SEED, 0, 0, 1, 1, TRAIN_SEQ, cfg.vocab).items()}
    opt = AdamW(lr=TRAIN_LR)
    bundle = build_step(cfg, train_shape(), make_smoke_mesh(),
                        multi_pod=False, opt=opt)
    step = bundle.step
    t0 = time.perf_counter()
    state = opt.init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    losses, walls = [], []
    for _ in range(TRAIN_STEPS):
        t1 = time.perf_counter()
        params, state, loss = step(params, state, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t1) * 1e3)
        losses.append(float(loss))
    launches = _counts()
    peak = torch.cuda.max_memory_allocated()
    loads = dict(build.load_count)
    MEASURED["train"] = {"max_memory_allocated": peak,
                         "param_bytes": tree_nbytes(params),
                         "opt_state_bytes": tree_nbytes([state.m, state.v])}
    emit("train", smi=smi, model=cfg.name, layers=cfg.n_layers,
         batch=1, seq=TRAIN_SEQ, lr=TRAIN_LR, step="build_step",
         losses=losses, step_wall_ms=walls, max_memory_allocated=peak,
         max_memory_gb=peak / 1e9, param_bytes=MEASURED["train"][
             "param_bytes"], opt_state_bytes=MEASURED["train"][
             "opt_state_bytes"], kernels=launches, library_loads=loads,
         seconds=time.perf_counter() - t0)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"a training loss is not finite: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    if any(launches[k] <= 0 for k in TRAIN_KERNELS):
        raise AssertionError(f"a kernel was not launched while training: "
                             f"{launches}")
    check_flash_route(launches, cfg.dtype, "the train step")
    if any(n != 1 for n in loads.values()):
        raise AssertionError(f"a kernel library was loaded twice: {loads}")
    if "--profile" in sys.argv[1:]:
        profile("train.profile", lambda: step(params, state, batch), 1)
    del state
    prefill_check(model, params, batch["tokens"])
    return launches, walls


def _plain(cfg, **kw):
    """The same model on the plain path on the card (``kernel_mode="torch"``:
    attention and the MoE's crossbar on their plain versions)."""
    from repro_torch.models.lm import DenseLM
    return DenseLM(dataclasses.replace(cfg, kernel_mode="torch"), **kw)


@torch.no_grad()
def prefill_check(model, params, tokens):
    """``DenseLM.prefill`` (bf16, S=4096) on the kernel path against the
    plain path on the card.  bf16 rounds at other places in the two
    attentions (the plain path scales q in bf16), which can flip a
    near-tied expert choice, so the last-token logits are held by their
    relative L2 distance."""
    t0 = time.perf_counter()
    logits = model.prefill(params, {"tokens": tokens})
    ref = _plain(model.cfg).prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    rel = float((logits.float() - ref.float()).norm() / ref.float().norm())
    finite = bool(torch.isfinite(logits).all())
    emit("prefill.check", seq=tokens.shape[1], shape=list(logits.shape),
         finite=finite, rel_l2=rel, tol=PREFILL_REL,
         max_abs_err=max_abs_err(logits, ref),
         seconds=time.perf_counter() - t0)
    if not (finite and rel <= PREFILL_REL
            and tuple(logits.shape) == (1, model.cfg.vocab_padded)):
        raise AssertionError("prefill logits disagree with the plain path")


def f32_check(cfg):
    """One float32 loss and backward of a 1-layer full-width model
    (S=1024) on the kernel path against the plain path on the card, TF32
    off.  Both paths plan and route the same packets and differ only in
    the order of the attention sums, so the loss and every gradient leaf
    are held within 1e-4 of the leaf's largest value (an earlier run on an
    H100 measured 3e-6), and every leaf must be nonzero."""
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.lm import DenseLM
    t0 = time.perf_counter()
    cfg32 = dataclasses.replace(cfg, n_layers=1, dtype="float32")
    model = DenseLM(cfg32)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 1)
    params = model.init(gen)
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    batch = {k: torch.from_numpy(v).cuda() for k, v in synthetic_batch(
        SEED, 1, 0, 1, 1, F32_SEQ, cfg.vocab).items()}
    out = {}
    for name, m in (("kernel", model), ("plain", _plain(cfg32))):
        _reset_counts()
        loss = m.loss(params, batch)
        out[name] = (float(loss.detach()),
                     torch.autograd.grad(loss, leaves), _counts())
        del loss
    torch.cuda.synchronize()
    (lk, gk, ck), (lp, gp, cp) = out["kernel"], out["plain"]
    rel = [float((a - b).abs().max() / b.abs().max()) for a, b in zip(gk, gp)]
    nonzero = all(float(a.abs().max()) > 0 for a in gk)
    emit("f32.check", layers=1, seq=F32_SEQ, params=sum(
        p.numel() for p in leaves), loss_kernel=lk, loss_plain=lp,
        grad_leaves=len(rel), grad_rel_max=max(rel), tol=F32_REL,
        grads_nonzero=nonzero, kernel_launches=ck, plain_launches=cp,
        seconds=time.perf_counter() - t0)
    if not (abs(lk - lp) <= F32_REL * abs(lp) and max(rel) <= F32_REL
            and nonzero and all(ck[k] > 0 for k in TRAIN_KERNELS)
            and not any(cp.values())):
        raise AssertionError("float32 loss or gradients disagree with the "
                             "plain path")
    check_flash_route(ck, "float32", "the float32 loss and backward")


# ----------------------------------------------------------------------
# the training runtime: the fabric's sanitizer, the MoE's other impls and
# TrainLoop with checkpoints and remat
# ----------------------------------------------------------------------
DEBUG_LEVELS = (False, "sanitize", "strict")
DEBUG_CALLS = 200       # calls a level is timed over (each syncs when on)
MOE_IMPL_REL = 2e-2     # bf16 MoE output of dense/gather vs cuda_kernel
TRAIN_LOOP_STEPS = 4    # runs R and B; run A crashes after its step-2 save
TRAIN_LOOP_CRASH = 2


class _Crash(Exception):
    """Run A's simulated crash, raised from its step-2 log."""


def wall_us(fn, calls: int = DEBUG_CALLS) -> float:
    """Wall microseconds per call of ``fn`` on an idle card, the calls'
    device work included (a sanitized call waits for its checks)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def fabric_debug_phase():
    """``Fabric(backend="cuda_kernel", debug=...)`` at the served decode and
    train shapes: plans, slabs and outputs under "sanitize" and "strict"
    bit-equal to ``debug=False`` on clean traffic, the same crossbar
    launches a call, a sprayed invalid destination and an over-capacity
    burst raising ``FabricCheckError`` under "strict" (masked, not raised,
    under "sanitize"), one library load, and each level's wall us a call
    of plan, dispatch and combine."""
    from repro_torch.core.registers import CrossbarRegisters
    from repro_torch.fabric import Fabric, FabricCheckError
    from repro_torch.kernels import build
    from repro_torch.kernels.crossbar_dispatch import kernel as K
    from repro_torch.models.moe import expert_capacity
    t0 = time.perf_counter()
    cfg = serving_config()
    E, d = cfg.moe.n_experts, cfg.d_model
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 7)
    shapes = {"moe_decode": (2, expert_capacity(1, cfg.moe)),
              "moe_train": (min(1024, TRAIN_SEQ) * cfg.moe.top_k,
                            expert_capacity(min(1024, TRAIN_SEQ), cfg.moe))}
    out = {}
    for case, (T, C) in shapes.items():
        regs = CrossbarRegisters.create(E, capacity=C, device="cuda")
        # clean traffic: every expert offered the same number of packets
        dst = (torch.randperm(T, generator=gen, device="cuda") % E).to(
            torch.int32)
        src = torch.zeros((T,), dtype=torch.int32, device="cuda")
        x = torch.randn((T, d), generator=gen, device="cuda").to(
            torch.bfloat16)
        w = torch.rand((T,), generator=gen, device="cuda").to(torch.bfloat16)
        res, calls, us = {}, {}, {}
        for level in DEBUG_LEVELS:
            fab = Fabric(regs, backend="cuda_kernel", capacity=C,
                         debug=level)
            K.reset_launch_counts()
            plan = fab.plan(dst, src)
            slabs, plan2 = fab.dispatch(x, dst, src)
            y = fab.combine(slabs, plan2, w)
            torch.cuda.synchronize()
            calls[str(level)] = K.launch_counts()
            res[level] = (plan, slabs, plan2, y)
            us[str(level)] = {
                "plan": wall_us(lambda: fab.plan(dst, src)),
                "dispatch": wall_us(lambda: fab.dispatch(x, dst, src)),
                "combine": wall_us(lambda: fab.combine(slabs, plan2, w))}
        base = res[False]
        same = {}
        for level in DEBUG_LEVELS[1:]:
            plan, slabs, plan2, y = res[level]
            same[level] = (all(torch.equal(getattr(p, f.name),
                                           getattr(q, f.name))
                               for p, q in ((plan, base[0]), (plan2, base[2]))
                               for f in dataclasses.fields(p))
                           and torch.equal(slabs, base[1])
                           and torch.equal(y, base[3]))
        strict = Fabric(regs, backend="cuda_kernel", capacity=C,
                        debug="strict")
        sanitize = Fabric(regs, backend="cuda_kernel", capacity=C,
                          debug="sanitize")
        spray = dst.clone()
        spray[0] = E + 3                         # a port that does not exist
        burst = torch.zeros((3 * C,), dtype=torch.int32, device="cuda")
        hostile = {"spray": (spray, src), "burst": (burst, torch.zeros_like(
            burst))}
        raised, masked = {}, {}
        for name, (hd, hs) in hostile.items():
            try:
                strict.plan(hd, hs)
                raised[name] = False
            except FabricCheckError:
                raised[name] = True
            masked[name] = int(sanitize.plan(hd, hs).keep.sum()) < hd.shape[0]
        out[case] = dict(T=T, C=C, bit_equal=same, launches=calls,
                         wall_us=us, strict_raises=raised,
                         sanitize_masks=masked)
        if not (all(same.values()) and all(raised.values())
                and all(masked.values())
                and all(c == calls["False"] for c in calls.values())):
            raise AssertionError(f"the sanitizer at {case}: {out[case]}")
    loads = dict(build.load_count)
    emit("fabric_debug", **out, library_loads=loads,
         seconds=time.perf_counter() - t0)
    if any(n != 1 for n in loads.values()):
        raise AssertionError(f"a kernel library was loaded twice: {loads}")
    _reset_counts()


def moe_impls_phase():
    """One Mixtral-8x7B MoE layer at its published widths (d=4096,
    d_ff=14336, E=8, top-2) at the train shape (T=4096 tokens, groups of
    1024), bf16, random weights from the seed: the dense and gather impls
    against ``cuda_kernel``, outputs within MOE_IMPL_REL relative L2 and
    counts, drops and isolation drops equal; each impl's ms."""
    from repro_torch.models.common import init_params
    from repro_torch.models.moe import moe_apply, moe_defs
    t0 = time.perf_counter()
    cfg = serving_config()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 8)
    params = init_params(moe_defs(cfg.d_model, cfg.d_ff, cfg.moe,
                                  cfg.mlp_act), gen, torch.bfloat16, "cuda")
    x = torch.randn((1, TRAIN_SEQ, cfg.d_model), generator=gen,
                    device="cuda").to(torch.bfloat16)
    group = min(1024, TRAIN_SEQ)

    def run(impl):
        return moe_apply(params, x, cfg.moe, cfg.mlp_act, group_size=group,
                         dispatch_impl=impl)

    out = {}
    with torch.no_grad():
        yk, sk = run("cuda_kernel")
        for impl in ("cuda_kernel", "dense", "gather"):
            y, s = run(impl)
            torch.cuda.synchronize()
            out[impl] = dict(
                ms=time_ms(lambda: run(impl), reps=5, warmup=1),
                rel_l2=rel_l2(y, yk), finite=bool(torch.isfinite(y).all()),
                counts=s["counts"].tolist(), dropped=int(s["dropped"]),
                iso_dropped=int(s["iso_dropped"]))
    ints = ("counts", "dropped", "iso_dropped")
    ok = all(o["finite"] and o["rel_l2"] <= MOE_IMPL_REL
             and all(o[k] == out["cuda_kernel"][k] for k in ints)
             for o in out.values())
    emit("moe_impls", tokens=TRAIN_SEQ, group=group, d=cfg.d_model,
         d_ff=cfg.d_ff, experts=cfg.moe.n_experts, top_k=cfg.moe.top_k,
         tol=MOE_IMPL_REL, **out, seconds=time.perf_counter() - t0)
    if not ok:
        raise AssertionError("the dense or gather MoE impl disagrees with "
                             "cuda_kernel")
    del params, x
    torch.cuda.empty_cache()
    _reset_counts()


SHARDED_RANKS = 4          # gloo ranks sharing the card: 2 experts a rank
SHARDED_BATCH = 4          # the T = 4096 tokens as [4, 1024, d]: a row a rank
SHARDED_STEPS = 2          # timed forward + backward steps after the check
SHARDED_TIMEOUT = 600.0    # seconds the ranks may take, start-up included
SHARDED_REGIONS = 7        # + the host port = 8 crossbar ports, an expert each
SHARDED_INTS = ("counts", "dropped", "iso_dropped", "offered_packets",
                "granted_packets", "local_packets", "remote_packets",
                "local_counts", "remote_counts")


def _sharded_layer(seed, device):
    """``moe_impls_phase``'s Mixtral-8x7B MoE layer (the same seed and
    draws), its T=4096 tokens as [SHARDED_BATCH, T / SHARDED_BATCH, d],
    and a cotangent of the output."""
    from repro_torch.models.common import init_params
    from repro_torch.models.moe import moe_defs
    cfg = serving_config()
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 8)
    params = init_params(moe_defs(cfg.d_model, cfg.d_ff, cfg.moe,
                                  cfg.mlp_act), gen, torch.bfloat16, device)
    x = torch.randn((1, TRAIN_SEQ, cfg.d_model), generator=gen,
                    device=device).to(torch.bfloat16)
    x = x.reshape(SHARDED_BATCH, TRAIN_SEQ // SHARDED_BATCH, cfg.d_model)
    ct = torch.randn(x.shape, generator=gen, device=device).to(torch.bfloat16)
    return cfg, params, x, ct


def _sharded_shell(capacity: int):
    """One tenant of SHARDED_REGIONS modules placed on as many regions, so
    the register file has 8 ports (the host's and one a region), an
    expert each."""
    from repro_torch.core.elastic import Region
    from repro_torch.core.module import ModuleFootprint
    from repro_torch.shell import Shell, Submit
    fp = ModuleFootprint(param_bytes=GB, flops_per_token=1e9,
                         activation_bytes_per_token=4096)
    shell = Shell([Region(rid=i, n_chips=1, hbm_bytes=80 * GB)
                   for i in range(SHARDED_REGIONS)], capacity=capacity)
    shell.post(Submit(tenant="moe", footprints=(fp,) * SHARDED_REGIONS,
                      app_id=0))
    return shell


def _layer_step(fn, params, x, ct, **kw):
    """Forward and backward of the MoE entry ``fn`` with the loss
    ``sum(y * ct) + aux_loss``: (y, stats, the gradients of x and of every
    parameter)."""
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    xg = x.detach().requires_grad_()
    y, stats = fn(leaves, xg, **kw)
    loss = (y.float() * ct.float()).sum() + stats["aux_loss"]
    grads = torch.autograd.grad(loss, [xg, *leaves.values()])
    return y.detach(), stats, dict(zip(["x", *leaves], grads))


def _against(got, want):
    """A sharded step (y, stats, grads) against the oracle's: integer stats
    equal, y and every gradient as relative L2 distances."""
    (y, st, g), (yo, so, go) = got, want
    ints = {k: bool(torch.equal(st[k].cpu(), so[k].cpu()))
            for k in SHARDED_INTS}
    out = dict(ints_equal=all(ints.values()),
               ints={k: st[k].tolist() for k in SHARDED_INTS},
               oracle_ints={k: so[k].tolist() for k in SHARDED_INTS},
               aux_loss=float(st["aux_loss"].detach()),
               oracle_aux_loss=float(so["aux_loss"].detach()),
               y_rel_l2=rel_l2(y, yo),
               grad_rel_l2={k: rel_l2(g[k], go[k]) for k in go},
               finite=bool(torch.isfinite(y).all()
                           and all(torch.isfinite(v).all()
                                   for v in g.values())))
    out["ok"] = (out["ints_equal"] and out["finite"]
                 and out["y_rel_l2"] <= MOE_IMPL_REL
                 and max(out["grad_rel_l2"].values()) <= MOE_IMPL_REL)
    return out


def _digest(y, grads) -> list:
    """Sums of a step's results in float64, chunk by chunk in a fixed
    order, to show that every rank holds the same global output and
    gradients."""
    return [sum(float(c.double().sum()) for c in _chunks(t))
            for t in (y, *grads.values())]


def sharded_rank(rank: int, n: int, tmp: str, seed: int) -> None:
    """One rank of the ``sharded`` phase (see ``sharded_phase``); writes
    its results to ``tmp/rank<rank>.json``."""
    import torch.distributed as dist
    torch.set_num_threads(2)        # 4 ranks and the parent share 8 cores
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method="file://" + os.path.join(
        tmp, "store"), rank=rank, world_size=n)
    try:
        out = _sharded_rank(rank, n, seed, dist, dev)
    except BaseException:
        # the peers of a failed rank fail too (their collectives lose it):
        # keep this rank's own traceback for the phase's message
        import traceback
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def _sharded_rank(rank, n, seed, dist, dev):
    from repro_torch.fabric import Fabric
    from repro_torch.fabric import collectives as coll
    from repro_torch.kernels import build
    from repro_torch.kernels.crossbar_dispatch import kernel as K
    from repro_torch.models.moe import (_moe_router, expert_capacity,
                                        moe_apply_sharded_reference,
                                        moe_fabric, moe_forward_sharded)
    from repro_torch.shell import FailRegion
    nccl = dist.new_group([0], backend="nccl")     # every rank takes part
    K.library()                                    # built by the parent
    cfg, params, x, ct = _sharded_layer(seed, dev)
    E, act = cfg.moe.n_experts, cfg.mlp_act
    cap = expert_capacity(TRAIN_SEQ, cfg.moe)
    shell = _sharded_shell(cap)
    out = {"rank": rank, "capacity": cap}

    def sharded(regs, group=None):
        return _layer_step(
            lambda p, xx: moe_forward_sharded(p, xx, cfg.moe, act,
                                              registers=regs, capacity=cap,
                                              group=group),
            params, x, ct)

    def oracle(regs, n_shards):
        return _layer_step(
            lambda p, xx: moe_apply_sharded_reference(
                p, xx, cfg.moe, act, n_shards=n_shards, registers=regs,
                capacity=cap), params, x, ct)

    # the main path: one forward and backward on every rank
    regs = shell.registers
    dist.barrier()
    torch.cuda.synchronize()
    K.reset_launch_counts()
    got = sharded(regs)
    torch.cuda.synchronize()
    out["launches"] = K.launch_counts()
    fabric = moe_fabric(E, cap, "sharded", device=dev)
    out["trace_before"] = fabric.trace_count
    out["digest"] = _digest(got[0], got[2])
    counts0 = got[1]["counts"].tolist()

    # this rank's plan, gathered: the reference plan of the same packets
    xl = x[rank * (x.shape[0] // n):(rank + 1) * (x.shape[0] // n)]
    dst, _, _ = _moe_router(params, xl.reshape(-1, cfg.d_model), cfg.moe,
                            None)
    zeros = torch.zeros_like(dst)
    plan = Fabric(regs, backend="sharded", capacity=cap,
                  device=dev).plan(dst, zeros)
    gathered = {f: coll.all_gather(getattr(plan, f).to(torch.int32))
                for f in ("keep", "slot", "error", "dst")}
    if rank == 0:
        want = oracle(regs, n)
        out["check"] = _against(got, want)
        full = torch.cat(gathered["dst"].unbind(0))
        dst_all, _, _ = _moe_router(params, x.reshape(-1, cfg.d_model),
                                    cfg.moe, None)
        src = torch.arange(n, dtype=torch.int32,
                           device=dev).repeat_interleave(dst.shape[0])
        ref = Fabric(regs, backend="reference", capacity=cap,
                     device=dev).plan(full, src)
        out["check"]["router_equal"] = bool(torch.equal(full, dst_all))
        out["check"]["plan_equal"] = all(
            torch.equal(torch.cat(gathered[f].unbind(0)),
                        getattr(ref, f).to(torch.int32))
            for f in ("keep", "slot", "error")) and bool(
            torch.equal(plan.counts, ref.counts)
            and torch.equal(plan.drops, ref.drops))
        out["check"]["ok"] &= out["check"]["plan_equal"]
        del want
    del got

    # timed steps: wall ms a step and the collectives' share of it
    coll.timing = True
    walls, shares = [], []
    for _ in range(SHARDED_STEPS):
        dist.barrier()
        torch.cuda.synchronize()
        coll.reset_stats()
        t0 = time.perf_counter()
        step = sharded(regs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        walls.append(wall * 1e3)
        shares.append(coll.stats["seconds"] / wall)
        out["collective_calls"] = coll.stats["calls"]
        out["collective_bytes"] = coll.stats["bytes"]
        del step
    coll.timing = False
    out["step_wall_ms"], out["collective_share"] = walls, shares

    # reconfiguration: the same FailRegion on every rank's shell
    shell.post(FailRegion(rid=1))
    regs1 = shell.registers
    got = sharded(regs1)
    out["trace_after"] = fabric.trace_count
    out["rerouted"] = got[1]["counts"].tolist() != counts0
    if rank == 0:
        out["reconf"] = _against(got, oracle(regs1, n))
    del got

    # NCCL at world size 1: the device-native transport on rank 0
    if rank == 0:
        K.reset_launch_counts()
        got = sharded(regs, group=nccl)
        torch.cuda.synchronize()
        out["nccl"] = _against(got, oracle(regs, 1))
        out["nccl"]["launches"] = K.launch_counts()
        out["nccl"]["transport"] = coll.transport(nccl)
        del got
    out["library_loads"] = dict(build.load_count)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    dist.barrier()
    return out


def join_ranks(ctx, timeout: float, what: str, tmp: str) -> None:
    """Wait for spawned ranks at most ``timeout`` seconds; a rank that
    raises fails this with every failed rank's traceback (``tmp/rank<r>
    .err``), one that hangs is killed with the others and fails it too."""
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise AssertionError(f"{what}: ranks still running after "
                                     f"{timeout} s")
    except Exception as e:
        errs = sorted(f for f in os.listdir(tmp) if f.endswith(".err"))
        texts = []
        for name in errs:
            with open(os.path.join(tmp, name)) as f:
                texts.append(f"--- {name}\n{f.read()}")
        raise AssertionError(f"{what}: {e}\n" + "\n".join(texts)) from e
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()


def sharded_phase(smi):
    """Mesh expert parallelism on the card: one Mixtral-8x7B MoE layer at
    its published widths (d=4096, d_ff=14336, E=8, top-2; bf16; T=4096 as
    [4, 1024, d]; capacity ``expert_capacity(4096)``, the weights and
    input of ``moe_impls_phase``) through ``moe_forward_sharded`` on
    SHARDED_RANKS ranks spawned over gloo, all on ``cuda:0`` (2 experts a
    rank, each rank's packets moved by the scatter and combine kernels).
    Rank 0 holds the forward and backward against
    ``moe_apply_sharded_reference`` on the card (the integer stats and the
    gathered plans equal, y and every gradient within MOE_IMPL_REL
    relative L2), every rank's output and gradients are the same, and
    every rank launches its scatter and combine kernels.  Then a
    ``FailRegion`` posted to every rank's ``Shell`` re-routes the next
    step as the oracle does with no new signature and one library load,
    and rank 0 runs the layer over NCCL at world size 1 against the
    oracle at one shard.  Returns the ranks' launches, summed."""
    import tempfile
    import torch.multiprocessing as mp
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="sharded_") as tmp:
        ctx = mp.start_processes(sharded_rank,
                                 args=(SHARDED_RANKS, tmp, SEED),
                                 nprocs=SHARDED_RANKS, join=False,
                                 start_method="spawn")
        join_ranks(ctx, SHARDED_TIMEOUT, "sharded", tmp)
        ranks = []
        for r in range(SHARDED_RANKS):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    r0 = ranks[0]
    launches = {}
    for r in ranks:
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    step_ms = [max(r["step_wall_ms"][i] for r in ranks)
               for i in range(SHARDED_STEPS)]
    emit("sharded", smi=smi, ranks=SHARDED_RANKS, device="cuda:0",
         transport="gloo: host (each collective staged through host "
                   "memory)", tokens=TRAIN_SEQ,
         d=serving_config().d_model, d_ff=serving_config().d_ff,
         experts=serving_config().moe.n_experts, capacity=r0["capacity"],
         tol=MOE_IMPL_REL, check=r0["check"], reconf=r0["reconf"],
         nccl=r0["nccl"], step_wall_ms=step_ms,
         collective_share=[max(r["collective_share"][i] for r in ranks)
                           for i in range(SHARDED_STEPS)],
         collective_calls=r0["collective_calls"],
         collective_bytes_per_rank=r0["collective_bytes"],
         launches_by_rank=[r["launches"] for r in ranks],
         library_loads_by_rank=[r["library_loads"] for r in ranks],
         trace_count=[(r["trace_before"], r["trace_after"]) for r in ranks],
         rerouted=[r["rerouted"] for r in ranks],
         peak_gb_by_rank=[r["peak_gb"] for r in ranks],
         seconds=time.perf_counter() - t0)
    fails = []
    if not (r0["check"]["ok"] and r0["check"]["router_equal"]):
        fails.append("the sharded layer disagrees with the oracle")
    if not r0["reconf"]["ok"]:
        fails.append("the step after FailRegion disagrees with the oracle")
    if not r0["nccl"]["ok"] or r0["nccl"]["transport"] != "device":
        fails.append("the NCCL leg disagrees with the oracle")
    if any(r["digest"] != r0["digest"] for r in ranks):
        fails.append("the ranks hold different outputs or gradients")
    for r in ranks:
        if r["launches"]["scatter"] <= 0 or r["launches"]["combine"] <= 0:
            fails.append(f"rank {r['rank']} launched no scatter or combine")
        if r["trace_after"] != r["trace_before"] or not r["rerouted"]:
            fails.append(f"rank {r['rank']}: FailRegion added a signature "
                         f"or did not re-route")
        if r["library_loads"] != {"crossbar_dispatch": 1}:
            fails.append(f"rank {r['rank']} loads: {r['library_loads']}")
    if fails:
        raise AssertionError("; ".join(fails))
    return launches


# ----------------------------------------------------------------------
# tensor parallelism: DenseLM over a (data, model) mesh of 4 ranks
# ----------------------------------------------------------------------
TP_MESH = (2, 2)               # ("data", "model"); 4 gloo ranks on cuda:0
TP_BATCH = 16                  # sharded over "data" (lm.batch_axes): 8 a rank
TP_SEQ = 2048
TP_STEPS = 3
TP_LR = 1e-3
TP_SLOTS = 16                  # ServeLoop slots, 8 a data rank
TP_PROMPT = 8                  # replayed through decode_step, then 8 new
TP_NEW = 8
TP_MOE_SEQ = 1024              # the 1-layer Mixtral's train step: B=16, S=1024
TP_MOE_GROUP = 1024            # the MoE layer's token groups (moe_impls')
TP_F32_LAYERS = 2
TP_F32_SEQ = 256
TP_F32_REL = 1e-4              # float32 loss and leaves vs the one-rank program
TP_TIMEOUT = 900.0
TP_KERNELS = ("flash_fwd", "flash_bwd")
TP_MOE_KERNELS = SERVE_KERNELS + TP_KERNELS


def tp_configs():
    """The phase's configs: TinyLlama-1.1B whole (22 layers, bf16, remat
    "dots"), Mixtral-8x7B cut to 1 layer (bf16, the MoE on the crossbar
    kernels) and the float32 control (TinyLlama at 2 layers on the plain
    path)."""
    from repro_torch.configs import get_config
    tiny = dataclasses.replace(get_config("tinyllama_1_1b"),
                               dtype="bfloat16")
    mix = get_config("mixtral_8x7b")
    mix = dataclasses.replace(mix, n_layers=1, dtype="bfloat16",
                              moe=dataclasses.replace(
                                  mix.moe, dispatch="cuda_kernel"))
    f32 = dataclasses.replace(tiny, n_layers=TP_F32_LAYERS, dtype="float32",
                              kernel_mode="torch")
    return {"tiny": tiny, "mixtral": mix, "f32": f32}


def tp_params(cfg, seed: int):
    """``cfg``'s global parameters on the card from ``seed`` (the same in
    every process)."""
    from repro_torch.models.lm import build_model
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    return build_model(cfg, device="cuda").init(gen)


def tp_batch(cfg, seq: int, seed: int):
    from repro_torch.data.pipeline import synthetic_batch
    return {k: torch.from_numpy(v).cuda() for k, v in synthetic_batch(
        seed, 0, 0, 1, TP_BATCH, seq, cfg.vocab).items()}


def tp_prompts(cfg):
    rng = np.random.default_rng(SEED + 20)
    return [rng.integers(0, cfg.vocab, TP_PROMPT).astype(np.int32)
            for _ in range(TP_SLOTS)]


def _save(tmp: str, name: str, tree) -> None:
    """A tree of card tensors to ``tmp/name``, on the host."""
    from repro_torch.models.common import tree_map
    torch.save(tree_map(lambda t: t.detach().cpu(), tree),
               os.path.join(tmp, name))


def tp_rank(rank: int, n: int, tmp: str, seed: int, body) -> None:
    """One rank of the ``tensor_parallel`` phase or of
    ``tensor_parallel_families``: ``body``, the rank's program
    (``_tp_rank`` or ``_tpf_rank``), called as ``body(rank, tmp, seed)``;
    writes its readings to
    ``tmp/rank<rank>.json`` and its shards to ``tmp/*_<rank>.pt``."""
    import torch.distributed as dist
    torch.set_num_threads(2)        # 4 ranks and the parent share 8 cores
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method="file://" + os.path.join(
        tmp, "store"), rank=rank, world_size=n)
    try:
        out = body(rank, tmp, seed)
    except BaseException:
        import traceback
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def _tp_rank(rank, tmp, seed):
    import warnings
    import torch.distributed as dist
    from repro_torch.fabric import collectives as coll
    from repro_torch.kernels import build
    from repro_torch.kernels.crossbar_dispatch import kernel as K
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.launch.steps import _value_and_grad, build_step
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.parallel import (ShardCtx, layout_specs,
                                             shard_params)
    from repro_torch.optim.adamw import AdamW
    from repro_torch.runtime.serve import Request, ServeLoop
    K.library()                                    # built by the parent
    FK.library()
    mesh = make_smoke_mesh(*TP_MESH)
    ctx = ShardCtx.launched(mesh)
    cfgs = tp_configs()
    out = {"rank": rank, "coords": list(ctx.coords)}

    def local_params(cfg, bundle, seed_):
        full = tp_params(cfg, seed_)
        local = shard_params(full, layout_specs(bundle.model), mesh,
                             ctx.coords)
        del full
        torch.cuda.empty_cache()
        return local

    def synced():
        dist.barrier()
        torch.cuda.synchronize()

    # --- TinyLlama-1.1B, 22 layers: prefill, ServeLoop, 3 AdamW steps ----
    tiny = cfgs["tiny"]
    shape = lambda kind, s=TP_SEQ: ShapeConfig(kind, s, TP_BATCH, kind)
    pre = build_step(tiny, shape("prefill"), mesh, multi_pod=False,
                     shard=ctx)
    params = local_params(tiny, pre, seed + 20)
    batch = tp_batch(tiny, TP_SEQ, seed)
    rows = pre.model.shard.batch_rows(TP_BATCH)
    mine = {k: v[rows] for k, v in batch.items()}
    synced()
    _reset_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits = pre.step(params, {"tokens": mine["tokens"]})
    torch.cuda.synchronize()
    out["prefill_ms"] = (time.perf_counter() - t0) * 1e3
    out["prefill_launches"] = _counts()
    _save(tmp, f"prefill_{rank}.pt", logits)
    out["prefill_finite"] = bool(torch.isfinite(logits).all())
    del logits

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        loop = ServeLoop(tiny, batch=TP_SLOTS, max_len=TP_PROMPT + TP_NEW,
                         params=params, shard=ctx)
    synced()
    t0 = time.perf_counter()
    comps = loop.serve([Request(app_id=i, prompt=p, max_new=TP_NEW)
                        for i, p in enumerate(tp_prompts(tiny))])
    out["serve_ms"] = (time.perf_counter() - t0) * 1e3
    out["serve_tokens"] = [c.tokens for c in comps]
    del loop

    opt = AdamW(lr=TP_LR)
    train = build_step(tiny, shape("train"), mesh, multi_pod=False, opt=opt,
                       shard=ctx)
    state = opt.init(params)
    torch.cuda.reset_peak_memory_stats()
    losses, walls, shares, calls, sent = [], [], [], [], []
    for i in range(TP_STEPS):
        coll.timing = i > 0            # step 1 untimed: its wall is clean
        coll.reset_stats()
        synced()
        t0 = time.perf_counter()
        params, state, loss = train.step(params, state, mine)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        losses.append(float(loss))
        walls.append(wall * 1e3)
        shares.append(coll.stats["seconds"] / wall if i else None)
        calls.append(coll.stats["calls"])
        sent.append(coll.stats["bytes"])
    coll.timing = False
    out.update(losses=losses, step_wall_ms=walls, collective_share=shares,
               collective_calls=calls[1:], collective_bytes=sent[1:],
               train_peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    del params, state, train, pre, mine, batch
    torch.cuda.empty_cache()

    # --- Mixtral-8x7B: the MoE layer forward and backward, then one train
    # step of the model cut to 1 layer ----------------------------------
    mix = cfgs["mixtral"]
    step = build_step(mix, shape("train", TP_MOE_SEQ), mesh, multi_pod=False,
                      opt=opt, shard=ctx)
    y, dx, grads = tp_moe_layer(step.model, seed)
    _save(tmp, f"moe_{rank}.pt", {"y": y, "dx": dx, "grads": grads})
    del y, dx, grads
    params = local_params(mix, step, seed + 21)
    mine = {k: v[rows] for k, v in tp_batch(mix, TP_MOE_SEQ, seed).items()}
    state = opt.init(params)
    synced()
    t0 = time.perf_counter()
    params, state, loss = step.step(params, state, mine)
    torch.cuda.synchronize()
    out["mixtral_step_ms"] = (time.perf_counter() - t0) * 1e3
    out["mixtral_loss"] = float(loss)
    out["launches"] = _counts()         # prefill to here: the main path
    out["mixtral_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del params, state, step, mine
    torch.cuda.empty_cache()

    # --- the float32 control: 2 layers on the plain path ----------------
    f32 = cfgs["f32"]
    ctl = build_step(f32, shape("train", TP_F32_SEQ), mesh, multi_pod=False,
                     shard=ctx)
    params = local_params(f32, ctl, seed + 22)
    mine = {k: v[rows] for k, v in tp_batch(f32, TP_F32_SEQ, seed).items()}
    before = _counts()
    loss, grads = _value_and_grad(ctl.model, params, mine)
    torch.cuda.synchronize()
    out["f32_loss"] = float(loss)
    out["f32_launches"] = {k: v - before[k] for k, v in _counts().items()}
    _save(tmp, f"f32_{rank}.pt", grads)
    out["library_loads"] = dict(build.load_count)
    dist.barrier()
    return out


def tp_moe_layer(model, seed):
    """``moe_impls_phase``'s Mixtral MoE layer (its weights, its T=4096
    tokens as [4, 1024, d] and a cotangent: ``_sharded_layer``) on this
    rank of ``model``'s mesh: its rows over ``data``, its shards of the
    weights (gathered over ``data``, each expert's ``d_ff`` half over
    ``model``), ``moe_apply`` on the crossbar kernels with ``shard``; the
    loss ``sum(y * ct) + aux_loss``.  Returns (y, the gradient of x: the
    rank's rows; the local gradient of every weight)."""
    from repro_torch.models.moe import moe_apply
    from repro_torch.models.parallel import layout_specs, shard_params
    sh = model.shard.with_batch("data")
    cfg, params, x, ct = _sharded_layer(seed, torch.device("cuda", 0))
    specs = layout_specs(model)["layers"][0]["moe"]
    local = {k: v.requires_grad_() for k, v in shard_params(
        params, specs, sh.mesh, sh.coords).items()}
    del params
    rows = sh.batch_rows(x.shape[0])
    xg = x[rows].clone().requires_grad_()
    y, stats = moe_apply(sh.weights(local, specs), xg, cfg.moe, cfg.mlp_act,
                         group_size=TP_MOE_GROUP, dispatch_impl="cuda_kernel",
                         shard=sh)
    loss = (y.float() * ct[rows].float()).sum() + stats["aux_loss"]
    grads = torch.autograd.grad(loss, [xg, *local.values()])
    return y.detach(), grads[0], dict(zip(local, grads[1:]))


def tensor_parallel_phase(smi):
    """Tensor parallelism and FSDP (``models/parallel.py``) on the card:
    TP_RANKS ranks spawned over gloo, all on ``cuda:0``, a (2, 2)
    ("data", "model") mesh (NCCL refuses two ranks on one card).  Each rank
    holds its shards (``shard_params``) and runs the kernels on them:

    - TinyLlama-1.1B whole (22 layers, bf16): a prefill at B=16, S=2048
      (16 local q heads, 2 kv heads: the ``tc`` flash kernels at D=64,
      G=8), ``ServeLoop`` with 16 slots x 8 new tokens (every rank the same
      tokens), 3 AdamW steps at B=16, S=2048, lr 1e-3, remat "dots", the
      batch sharded over ``data`` (steps 2 and 3 with
      ``collectives.timing`` for the collectives' share, calls and bytes);
    - Mixtral-8x7B: its MoE layer (``moe_impls``' weights and T=4096
      tokens, 2 of the 4 rows a data rank, each expert's ``d_ff`` half a
      model rank) forward and backward, then one train step of the model
      cut to 1 layer (bf16, B=16, S=1024), with the crossbar plan, scatter
      and combine on every rank's tokens (16 local q heads, 4 kv heads,
      D=128);
    - the float32 control: TinyLlama at 2 layers, full width, on the plain
      path (B=16, S=256): the loss and its gradients.

    Then the parent, alone on the card, holds them against the one-rank
    programs on the same parameters: the bf16 prefill logits within
    PREFILL_REL relative L2 of the kernel path, the MoE layer's output and
    the gradients of its input and of every weight within MOE_IMPL_REL
    relative L2 (the ``moe_impls`` limit), the 1-layer model's loss within
    MOE_IMPL_REL, the float32 loss and leaves within TP_F32_REL of the
    leaf's largest value; and runs the TinyLlama train
    step over NCCL on a (1, 1) mesh, whose loss must equal the one-rank
    step's bit for bit on the same kernels.  Launches are the ranks'
    prefill, serve, train and Mixtral launches, summed."""
    import tempfile
    import torch.multiprocessing as mp
    t0 = time.perf_counter()
    n = TP_MESH[0] * TP_MESH[1]
    with tempfile.TemporaryDirectory(prefix="tp_") as tmp:
        ctx = mp.start_processes(tp_rank, args=(n, tmp, SEED, _tp_rank),
                                 nprocs=n, join=False, start_method="spawn")
        join_ranks(ctx, TP_TIMEOUT, "tensor_parallel", tmp)
        ranks = []
        for r in range(n):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        t1 = time.perf_counter()
        checks = tp_checks(tmp, ranks)
    r0 = ranks[0]
    launches = {}
    for r in ranks:
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    nccl = tp_nccl()
    emit("tensor_parallel", smi=smi, mesh=list(TP_MESH), ranks=n,
         device="cuda:0", transport="gloo: host (each collective staged "
         "through host memory)", batch=TP_BATCH, seq=TP_SEQ,
         tiny_losses=r0["losses"],
         step_wall_ms=[r["step_wall_ms"] for r in ranks],
         collective_share=[r["collective_share"] for r in ranks],
         collective_calls=[r["collective_calls"] for r in ranks],
         collective_bytes=[r["collective_bytes"] for r in ranks],
         prefill_ms=[r["prefill_ms"] for r in ranks],
         serve_ms=[r["serve_ms"] for r in ranks],
         mixtral_step_ms=[r["mixtral_step_ms"] for r in ranks],
         train_peak_gb=[r["train_peak_gb"] for r in ranks],
         mixtral_peak_gb=[r["mixtral_peak_gb"] for r in ranks],
         launches_by_rank=[r["launches"] for r in ranks],
         library_loads_by_rank=[r["library_loads"] for r in ranks],
         checks=checks, nccl=nccl, ranks_seconds=t1 - t0,
         seconds=time.perf_counter() - t0)
    fails = [k for k, v in checks.items() if isinstance(v, dict)
             and not v["ok"]]
    if not nccl["ok"]:
        fails.append("nccl")
    losses = r0["losses"]
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        fails.append(f"tinyllama losses {losses}")
    if any(r["losses"] != losses for r in ranks):
        fails.append("the ranks report different losses")
    if any(r["serve_tokens"] != r0["serve_tokens"] for r in ranks) or any(
            len(t) != TP_NEW for t in r0["serve_tokens"]):
        fails.append("the ranks served different tokens")
    for r in ranks:
        lc = r["launches"]
        if any(lc[f"{k}_tc"] <= 0 for k in TP_KERNELS) or any(
                lc[f"{k}_fma"] for k in TP_KERNELS):
            fails.append(f"rank {r['rank']}: not only tc flash: {lc}")
        if any(lc[k] <= 0 for k in SERVE_KERNELS):
            fails.append(f"rank {r['rank']}: no crossbar launch: {lc}")
        if r["library_loads"].get("crossbar_dispatch") != 1 or any(
                v != 1 for v in r["library_loads"].values()):
            fails.append(f"rank {r['rank']} loads: {r['library_loads']}")
        if any(r["f32_launches"].values()):
            fails.append(f"rank {r['rank']}: the float32 control launched "
                         f"a kernel")
        if not r["prefill_finite"]:
            fails.append(f"rank {r['rank']}: prefill logits not finite")
    if fails:
        raise AssertionError(f"tensor_parallel: {fails}")
    return launches


def _unshard(tmp: str, name: str, specs, mesh):
    from repro_torch.models.parallel import unshard_params
    n = mesh.size
    return unshard_params([torch.load(os.path.join(tmp, f"{name}_{r}.pt"))
                           for r in range(n)], specs, mesh)


def tp_checks(tmp: str, ranks):
    """The ranks' results unsharded on the host, against the one-rank
    programs run here on the card on the same parameters and batches."""
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.launch.steps import _value_and_grad
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.lm import build_model
    from repro_torch.models.parallel import layout_specs
    mesh = make_smoke_mesh(*TP_MESH)
    cfgs = tp_configs()
    out = {}

    # bf16 prefill logits against the one-rank kernel path
    tiny = cfgs["tiny"]
    model = build_model(tiny)
    params = tp_params(tiny, SEED + 20)
    tokens = tp_batch(tiny, TP_SEQ, SEED)["tokens"]
    with torch.no_grad():
        ref = model.prefill(params, {"tokens": tokens}).float().cpu()
    got = _unshard(tmp, "prefill", ("data", "model"), mesh).float()
    rel = float((got - ref).norm() / ref.norm())
    out["prefill"] = {"rel_l2": rel, "tol": PREFILL_REL,
                      "max_abs_err": float((got - ref).abs().max()),
                      "ok": rel <= PREFILL_REL and got.shape == ref.shape}
    del params, model
    torch.cuda.empty_cache()

    # the MoE layer: output and every gradient, relative L2
    from repro_torch.models.moe import moe_apply
    cfg, params, x, ct = _sharded_layer(SEED, torch.device("cuda", 0))
    want = _layer_step(lambda p, xx: moe_apply(
        p, xx, cfg.moe, cfg.mlp_act, group_size=TP_MOE_GROUP,
        dispatch_impl="cuda_kernel"), params, x, ct)
    specs = layout_specs(build_model(cfgs["mixtral"], device="meta"))
    specs = specs["layers"][0]["moe"]
    rows = ("data", None, None)
    got = _unshard(tmp, "moe", {"y": rows, "dx": rows, "grads": specs}, mesh)
    errs = {"y": rel_l2(got["y"].cuda(), want[0]),
            "x": rel_l2(got["dx"].cuda(), want[2]["x"])}
    errs.update({k: rel_l2(got["grads"][k].cuda(), want[2][k])
                 for k in specs})
    out["moe_layer"] = {"rel_l2": errs, "tol": MOE_IMPL_REL,
                        "ok": max(errs.values()) <= MOE_IMPL_REL}
    del params, x, ct, want, got
    torch.cuda.empty_cache()

    # the 1-layer Mixtral's loss (step 1 of its train step); the float32
    # control's loss and every gradient leaf
    for name, cfg, seq, seed, tol in (
            ("mixtral", cfgs["mixtral"], TP_MOE_SEQ, SEED + 21,
             MOE_IMPL_REL),
            ("f32", cfgs["f32"], TP_F32_SEQ, SEED + 22, TP_F32_REL)):
        model = build_model(cfg)
        params = tp_params(cfg, seed)
        batch = tp_batch(cfg, seq, SEED)
        tp_loss = ranks[0][f"{name}_loss"]
        if name == "mixtral":
            with torch.no_grad():
                loss = model.loss(params, batch)
            errs = []
        else:
            loss, grads = _value_and_grad(model, params, batch)
            got = _unshard(tmp, name, layout_specs(model), mesh)
            errs = [float((g.cuda() - w).abs().max() / w.abs().max())
                    for g, w in zip(tree_leaves(got), tree_leaves(grads))]
            del grads, got
        loss_err = abs(tp_loss - float(loss)) / abs(float(loss))
        out[name] = {"loss": tp_loss, "one_rank_loss": float(loss),
                     "loss_rel_err": loss_err, "tol": tol,
                     "ok": loss_err <= tol and all(e <= tol for e in errs)}
        if errs:
            out[name].update(leaves=len(errs), grad_err_max=max(errs),
                             measure="of the leaf's largest value")
        del params, model
        torch.cuda.empty_cache()
    return out


def tp_nccl():
    """The TinyLlama train step (B=16, S=2048, bf16, on the kernels) over
    NCCL on a (1, 1) mesh in this process, against the one-rank step
    without a mesh: step 1's loss bit for bit."""
    import tempfile
    import torch.distributed as dist
    from repro_torch.fabric import collectives as coll
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.launch.steps import build_step
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.parallel import ShardCtx
    from repro_torch.optim.adamw import AdamW
    t0 = time.perf_counter()
    tiny = tp_configs()["tiny"]
    shape = ShapeConfig("train", TP_SEQ, TP_BATCH, "train")
    mesh = make_smoke_mesh(1, 1)
    batch = tp_batch(tiny, TP_SEQ, SEED)
    losses = {}
    with tempfile.TemporaryDirectory(prefix="nccl_") as tmp:
        dist.init_process_group("nccl", init_method="file://" + os.path.join(
            tmp, "store"), rank=0, world_size=1)
        try:
            for name in ("one_rank", "nccl"):
                shard = ShardCtx.launched(mesh) if name == "nccl" else None
                opt = AdamW(lr=TP_LR)
                bundle = build_step(tiny, shape, mesh, multi_pod=False,
                                    opt=opt, shard=shard)
                params = tp_params(tiny, SEED + 20)
                coll.reset_stats()
                coll.timing = name == "nccl"
                _reset_counts()
                _, _, loss = bundle.step(params, opt.init(params), batch)
                torch.cuda.synchronize()
                coll.timing = False
                losses[name] = {"loss": float(loss), "launches": _counts(),
                                "collective_calls": coll.stats["calls"],
                                "transport": (coll.transport(shard.world)
                                              if shard else None)}
                del params, bundle
                torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()
    a, b = losses["one_rank"], losses["nccl"]
    return {**losses, "bit_equal": a["loss"] == b["loss"],
            "ok": (a["loss"] == b["loss"] and b["transport"] == "device"
                   and b["collective_calls"] > 0
                   and a["launches"] == b["launches"]),
            "seconds": time.perf_counter() - t0}


# ----------------------------------------------------------------------
# tensor parallelism of the SSM, hybrid and encoder-decoder families
# ----------------------------------------------------------------------
TPF_ARCHS = ("mamba2_780m", "recurrentgemma_9b", "whisper_medium")
TPF_LAYERS = {"recurrentgemma_9b": 6}      # 2 groups, as train_hybrid
# the depth of the short bf16 program and of the float32 control
TPF_SHORT_LAYERS = {"mamba2_780m": 2, "recurrentgemma_9b": 3,
                    "whisper_medium": 2}   # hybrid: 1 group; encdec: 2 + 2
TPF_F32_SEQ = 256
# The short bf16 program (TPF_SHORT_LAYERS, on the kernels, S=4096) on the
# ranks against one rank, relative L2: last-token logits and each gradient
# leaf, about twice the worst that the ranks read on the H100 (1.41e-2,
# RecurrentGemma's logits; 5.42e-2, Whisper's enc_layers[0].norm2), where
# the one-rank plain path reads up to 7.61e-2 on a leaf against the
# one-rank kernels (Whisper's dec_layers[1].attn.wk; PERF.md)
TPF_SHORT_LOGITS_REL = 3e-2
TPF_SHORT_GRAD_REL = 1e-1
# the bf16 loss, full depth and short, relative to the one-rank program's:
# the ranks read 2.5e-5 at most on the H100 (PERF.md)
TPF_LOSS_REL = 1e-3
TPF_PEAK_GB = 76.0             # the ranks' peaks, summed, on the one card
# the kernels each family's bf16 prefill and train step must launch
TPF_KERNELS = {"mamba2_780m": ("ssd", "ssd_bwd"),
               "recurrentgemma_9b": ("rglru", "rglru_bwd", "flash_fwd_d256",
                                     "flash_bwd_d256"),
               "whisper_medium": ("flash_fwd", "flash_bwd")}
TPF_FMA = ("flash_fwd_fma", "flash_bwd_fma", "flash_fwd_d256_fma",
           "flash_bwd_d256_fma")


def tpf_config(arch, kind: str = "full"):
    """The phase's config of ``arch`` at its published widths: ``"full"``,
    bf16 (Mamba-2 780M and Whisper-medium whole, RecurrentGemma-9B cut to 2
    groups); ``"short"``, bf16 at TPF_SHORT_LAYERS (2 layers; the hybrid 1
    group; Whisper 2 encoder and 2 decoder layers); ``"f32"``, that depth
    in float32 on the plain path."""
    if kind == "full":
        return published_config(arch, **({"n_layers": TPF_LAYERS[arch]}
                                         if arch in TPF_LAYERS else {}))
    n = TPF_SHORT_LAYERS[arch]
    kw = {"n_encoder_layers": n} if arch == "whisper_medium" else {}
    if kind == "f32":
        kw.update(dtype="float32", kernel_mode="torch")
    return published_config(arch, n_layers=n, **kw)


def tpf_batch(cfg, seq: int, seed: int):
    """One row of ``seq`` tokens and labels (and Whisper's 1,500 frames)
    on the card, from ``seed``."""
    from repro_torch.data.pipeline import synthetic_batch
    batch = {k: torch.from_numpy(v).cuda() for k, v in synthetic_batch(
        seed, 0, 0, 1, 1, seq, cfg.vocab).items()}
    if cfg.family == "encdec":
        batch.update(family_input(cfg, np.random.default_rng(seed)))
    return batch


def _no_labels(batch):
    return {k: v for k, v in batch.items() if k != "labels"}


def _tpf_rank(rank, tmp, seed):
    """A rank's program of ``tensor_parallel_families``: each family's
    prefill and train step, its short bf16 program's prefill, loss and
    gradients, and its float32 control, on its shards."""
    import torch.distributed as dist
    from repro_torch.fabric import collectives as coll
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.launch.steps import _value_and_grad, build_step
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.parallel import (ShardCtx, layout_specs,
                                             shard_params)
    from repro_torch.optim.adamw import AdamW
    for mod in _kernel_modules():
        mod.library()                              # built by the parent
    mesh = make_smoke_mesh(*TP_MESH)
    ctx = ShardCtx.launched(mesh)
    out = {"rank": rank, "coords": list(ctx.coords), "families": {}}

    def local_params(cfg, bundle, seed_):
        full = tp_params(cfg, seed_)
        local = shard_params(full, layout_specs(bundle.model), mesh,
                             ctx.coords)
        del full
        torch.cuda.empty_cache()
        return local

    def synced():
        dist.barrier()
        torch.cuda.synchronize()

    for i, arch in enumerate(TPF_ARCHS):
        cfg = tpf_config(arch)
        rec = {}
        shape = lambda kind, s=TRAIN_SEQ: ShapeConfig(kind, s, 1, kind)  # noqa: E731
        pre = build_step(cfg, shape("prefill"), mesh, multi_pod=False,
                         shard=ctx)
        params = local_params(cfg, pre, seed + 30 + i)
        rows = pre.model.shard.batch_rows(1)
        mine = {k: v[rows] for k, v in tpf_batch(cfg, TRAIN_SEQ,
                                                 seed).items()}
        torch.cuda.reset_peak_memory_stats()
        synced()
        _reset_counts()
        t0 = time.perf_counter()
        with torch.no_grad():
            logits = pre.step(params, _no_labels(mine))
        torch.cuda.synchronize()
        rec["prefill_ms"] = (time.perf_counter() - t0) * 1e3
        rec["prefill_finite"] = bool(torch.isfinite(logits).all())
        _save(tmp, f"{arch}_prefill_{rank}.pt", logits)
        del logits

        opt = AdamW(lr=TRAIN_LR)
        train = build_step(cfg, shape("train"), mesh, multi_pod=False,
                           opt=opt, shard=ctx)
        state = opt.init(params)
        coll.reset_stats()
        synced()
        coll.timing = True
        t0 = time.perf_counter()
        params, state, loss = train.step(params, state, mine)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        coll.timing = False
        rec.update(loss=float(loss), step_wall_ms=wall * 1e3,
                   collective_share=coll.stats["seconds"] / wall,
                   collective_calls=coll.stats["calls"],
                   collective_bytes=coll.stats["bytes"],
                   launches=_counts(),
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        del params, state, train, pre
        torch.cuda.empty_cache()

        # the short bf16 program on the kernels: logits, loss, gradients
        short = tpf_config(arch, "short")
        sb = build_step(short, shape("train"), mesh, multi_pod=False,
                        shard=ctx)
        params = local_params(short, sb, seed + 50 + i)
        before = _counts()
        with torch.no_grad():
            _save(tmp, f"{arch}_short_prefill_{rank}.pt",
                  sb.model.prefill(params, _no_labels(mine)))
        loss, grads = _value_and_grad(sb.model, params, mine)
        torch.cuda.synchronize()
        rec["short_loss"] = float(loss)
        rec["short_launches"] = {k: v - before[k]
                                 for k, v in _counts().items()}
        _save(tmp, f"{arch}_short_{rank}.pt", grads)
        del params, grads, sb, mine
        torch.cuda.empty_cache()

        # the float32 control: the plain path, the loss and its gradients
        f32 = tpf_config(arch, "f32")
        ctl = build_step(f32, shape("train", TPF_F32_SEQ), mesh,
                         multi_pod=False, shard=ctx)
        params = local_params(f32, ctl, seed + 40 + i)
        mine = {k: v[rows] for k, v in tpf_batch(f32, TPF_F32_SEQ,
                                                 seed).items()}
        before = _counts()
        loss, grads = _value_and_grad(ctl.model, params, mine)
        torch.cuda.synchronize()
        rec["f32_loss"] = float(loss)
        rec["f32_launches"] = {k: v - before[k] for k, v in _counts().items()}
        _save(tmp, f"{arch}_f32_{rank}.pt", grads)
        del params, grads, ctl, mine
        torch.cuda.empty_cache()
        out["families"][arch] = rec
    out["library_loads"] = dict(build.load_count)
    dist.barrier()
    return out


def _worst(names, errs):
    i = int(np.argmax(errs))
    return names[i], errs[i]


def tpf_checks(tmp: str, ranks):
    """The ranks' results unsharded on the host, against the one-rank
    programs run here on the card on the same parameters and batches.

    - Full depth, bf16, on the kernels: the last-token prefill logits
      within PREFILL_REL relative L2, or else within
      PREFILL_CONTROL_FACTOR times the plain path's ``rounding_controls``
      of the same run, as the serve phases hold full-depth logits
      (``prefill_limit`` names which held: Mamba-2's 48 random layers
      carry any rounding-sized difference to some 0.26); the loss within
      TPF_LOSS_REL.
    - The short bf16 program (TPF_SHORT_LAYERS, on the kernels, where
      rounding does not grow with depth): the last-token logits within
      TPF_SHORT_LOGITS_REL and every gradient leaf within
      TPF_SHORT_GRAD_REL relative L2, the loss within TPF_LOSS_REL.  The
      one-rank plain path against the one-rank kernels is recorded beside
      them (``short_control_*``): the distance between two right bf16
      programs at that depth.
    - The float32 control (plain path): the loss and every gradient leaf
      within TP_F32_REL of the leaf's largest value, the worst leaf named,
      and beside it how far one float32 ulp of every parameter moves that
      leaf of the one-rank program (``f32_one_ulp``): the leaf's own
      conditioning."""
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.launch.steps import _value_and_grad
    from repro_torch.models.common import leaf_names, tree_leaves
    from repro_torch.models.lm import build_model
    from repro_torch.models.parallel import layout_specs
    mesh = make_smoke_mesh(*TP_MESH)
    out = {}
    for i, arch in enumerate(TPF_ARCHS):
        fam = ranks[0]["families"][arch]
        cfg = tpf_config(arch)
        model = build_model(cfg)
        params = tp_params(cfg, SEED + 30 + i)
        batch = tpf_batch(cfg, TRAIN_SEQ, SEED)
        plain = build_model(dataclasses.replace(cfg, kernel_mode="torch"))
        with torch.no_grad():
            ref = model.prefill(params, _no_labels(batch)).float().cpu()
            loss = float(model.loss(params, batch))
            plain_ref = plain.prefill(params, _no_labels(batch))
            control_name, control = rounding_controls(
                plain, params, _no_labels(batch), plain_ref)
        got = _unshard(tmp, f"{arch}_prefill", (None, "model"), mesh).float()
        rel = float((got - ref).norm() / ref.norm())
        limit = ("rel_l2" if rel <= PREFILL_REL else "control"
                 if rel <= PREFILL_CONTROL_FACTOR * control else None)
        loss_err = abs(fam["loss"] - loss) / abs(loss)
        rec = {"prefill_rel_l2": rel, "prefill_tol": PREFILL_REL,
               "prefill_max_abs_err": float((got - ref).abs().max()),
               "control": control_name, "control_rel_l2": control,
               "control_tol": PREFILL_CONTROL_FACTOR * control,
               "prefill_limit": limit,
               "loss": fam["loss"], "one_rank_loss": loss,
               "loss_rel_err": loss_err, "loss_tol": TPF_LOSS_REL}
        del params, model, plain, plain_ref, ref, got
        torch.cuda.empty_cache()

        short = tpf_config(arch, "short")
        model = build_model(short)
        plain = build_model(dataclasses.replace(short, kernel_mode="torch"))
        params = tp_params(short, SEED + 50 + i)
        names = leaf_names(params)
        with torch.no_grad():
            ref = model.prefill(params, _no_labels(batch))
            plain_ref = plain.prefill(params, _no_labels(batch))
        loss, grads = _value_and_grad(model, params, batch)
        plain_loss, plain_grads = _value_and_grad(plain, params, batch)
        got = _unshard(tmp, f"{arch}_short_prefill", (None, "model"), mesh)
        errs = [rel_l2(g.cuda(), w) for g, w in zip(
            tree_leaves(_unshard(tmp, f"{arch}_short", layout_specs(model),
                                 mesh)), tree_leaves(grads))]
        ctl = [rel_l2(p, w) for p, w in
               zip(tree_leaves(plain_grads), tree_leaves(grads))]
        leaf, worst = _worst(names, errs)
        ctl_leaf, ctl_worst = _worst(names, ctl)
        short_rel = rel_l2(got.cuda().float(), ref.float())
        short_loss_err = abs(fam["short_loss"] - float(loss)) / abs(
            float(loss))
        rec.update(short_layers=short.n_layers,
                   short_logits_rel_l2=short_rel,
                   short_logits_tol=TPF_SHORT_LOGITS_REL,
                   short_loss_rel_err=short_loss_err,
                   short_grad_leaves=len(errs), short_grad_rel_l2_max=worst,
                   short_grad_worst_leaf=leaf,
                   short_grad_tol=TPF_SHORT_GRAD_REL,
                   short_control_logits_rel_l2=rel_l2(plain_ref.float(),
                                                      ref.float()),
                   short_control_loss_rel_err=abs(
                       float(plain_loss) - float(loss)) / abs(float(loss)),
                   short_control_grad_rel_l2_max=ctl_worst,
                   short_control_worst_leaf=ctl_leaf)
        short_ok = (short_rel <= TPF_SHORT_LOGITS_REL
                    and worst <= TPF_SHORT_GRAD_REL
                    and short_loss_err <= TPF_LOSS_REL)
        del params, model, plain, plain_ref, ref, got, grads, plain_grads
        torch.cuda.empty_cache()

        f32 = tpf_config(arch, "f32")
        model = build_model(f32)
        params = tp_params(f32, SEED + 40 + i)
        f32_batch = tpf_batch(f32, TPF_F32_SEQ, SEED)
        loss, grads = _value_and_grad(model, params, f32_batch)
        got = _unshard(tmp, f"{arch}_f32", layout_specs(model), mesh)
        errs = [float((g.cuda() - w).abs().max() / w.abs().max())
                for g, w in zip(tree_leaves(got), tree_leaves(grads))]
        names = leaf_names(params)
        leaf, worst = _worst(names, errs)
        # one float32 ulp of every parameter, the leaves' own conditioning
        bits = [p.data.view(torch.int32) for p in tree_leaves(params)]
        for b in bits:
            b.add_(1)
        try:
            _, nudged = _value_and_grad(model, params, f32_batch)
        finally:
            for b in bits:
                b.sub_(1)
        ulp = [float((n - w).abs().max() / w.abs().max())
               for n, w in zip(tree_leaves(nudged), tree_leaves(grads))]
        f32_err = abs(fam["f32_loss"] - float(loss)) / abs(float(loss))
        rec.update(f32_loss=fam["f32_loss"], f32_one_rank_loss=float(loss),
                   f32_loss_rel_err=f32_err, f32_leaves=len(errs),
                   f32_grad_err_max=worst, f32_worst_leaf=leaf,
                   f32_one_ulp=ulp[names.index(leaf)], f32_one_ulp_max=max(ulp),
                   f32_tol=TP_F32_REL,
                   f32_measure="of the leaf's largest value")
        rec["ok"] = (limit is not None and loss_err <= TPF_LOSS_REL
                     and short_ok and f32_err <= TP_F32_REL
                     and worst <= TP_F32_REL)
        out[arch] = rec
        del params, model, grads, nudged, got
        torch.cuda.empty_cache()
    return out


def tpf_nccl():
    """One Mamba-2 780M train step (bf16, S=4096, on the kernels) over NCCL
    on a (1, 1) mesh in this process, against the step without a mesh:
    the loss bit for bit, the same launches, the collectives on the
    device."""
    import tempfile
    import torch.distributed as dist
    from repro_torch.fabric import collectives as coll
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.launch.steps import build_step
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.parallel import ShardCtx
    from repro_torch.optim.adamw import AdamW
    t0 = time.perf_counter()
    arch = TPF_ARCHS[0]
    cfg = tpf_config(arch)
    shape = ShapeConfig("train", TRAIN_SEQ, 1, "train")
    mesh = make_smoke_mesh(1, 1)
    batch = tpf_batch(cfg, TRAIN_SEQ, SEED)
    losses = {}
    with tempfile.TemporaryDirectory(prefix="nccl_") as tmp:
        dist.init_process_group("nccl", init_method="file://" + os.path.join(
            tmp, "store"), rank=0, world_size=1)
        try:
            for name in ("one_rank", "nccl"):
                shard = ShardCtx.launched(mesh) if name == "nccl" else None
                opt = AdamW(lr=TRAIN_LR)
                bundle = build_step(cfg, shape, mesh, multi_pod=False,
                                    opt=opt, shard=shard)
                params = tp_params(cfg, SEED + 30)
                coll.reset_stats()
                coll.timing = name == "nccl"
                _reset_counts()
                _, _, loss = bundle.step(params, opt.init(params), batch)
                torch.cuda.synchronize()
                coll.timing = False
                losses[name] = {"loss": float(loss), "launches": _counts(),
                                "collective_calls": coll.stats["calls"],
                                "transport": (coll.transport(shard.world)
                                              if shard else None)}
                del params, bundle
                torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()
    a, b = losses["one_rank"], losses["nccl"]
    return {"model": cfg.name, **losses, "bit_equal": a["loss"] == b["loss"],
            "ok": (a["loss"] == b["loss"] and b["transport"] == "device"
                   and b["collective_calls"] > 0
                   and a["launches"] == b["launches"]),
            "seconds": time.perf_counter() - t0}


TPF_DRY_KEYS = ("flops_per_device", "bytes_per_device",
                "collective_bytes_per_device", "collectives",
                "peak_memory_est", "fits_hbm", "microbatches", "param_bytes",
                "opt_state_bytes", "bottleneck", "roofline_fraction",
                "t_compute", "t_memory", "t_collective", "lower_s")


def tpf_dry_runs():
    """``dryrun.run_cell`` of the three published configs' ``train_4k`` on
    the pod (16 x 16), rank 0's FLOPs, collectives and peak costed on the
    meta device: host work, started in a process of its own so that it
    runs while the ranks do.  Returns the process; ``tpf_dry_records``
    reads its records."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (os.path.join(HERE, "src"),
                    os.environ.get("PYTHONPATH")) if p),
        OMP_NUM_THREADS="1")
    code = ("import sys\n"
            "from pathlib import Path\n"
            "from repro_torch.launch import dryrun\n"
            "for arch in sys.argv[2:]:\n"
            "    dryrun.run_cell(arch, 'train_4k', 'pod', Path(sys.argv[1]))\n")
    return subprocess.Popen(
        [sys.executable, "-c", code, os.path.join(HERE, "build", "dryrun"),
         *TPF_ARCHS], cwd=HERE, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def tpf_dry_records(proc):
    """The dry runs' records, once ``proc`` (``tpf_dry_runs``) ends."""
    out, _ = proc.communicate(timeout=TP_TIMEOUT)
    if proc.returncode:
        raise AssertionError(f"the pod dry runs failed:\n{out[-3000:]}")
    recs = {}
    for arch in TPF_ARCHS:
        with open(os.path.join(HERE, "build", "dryrun",
                               f"{arch}_train_4k_pod.json")) as f:
            rec = json.load(f)
        recs[arch] = {k: rec[k] for k in TPF_DRY_KEYS}
    return recs


def tensor_parallel_families_phase(smi):
    """Tensor parallelism and FSDP of the SSM, hybrid and encoder-decoder
    families (``models/parallel.py``) on the card: TP_RANKS ranks spawned
    over gloo, all on ``cuda:0``, a (2, 2) ("data", "model") mesh.  Each
    rank holds its shards of Mamba-2 780M whole (48 layers: 24 SSD heads a
    rank, B and C gathered over ``model``), RecurrentGemma-9B cut to 2
    groups (2,048 RG-LRU channels, 8 q heads and the kv head a rank) and
    Whisper-medium whole (8 heads a rank, its encoder output replicated
    over ``model``), bf16, random weights from the seed, and runs on the
    kernels one prefill and one AdamW step (lr 1e-3, remat "dots") at B=1,
    S=4096 (the row replicated over ``data``; Whisper with 1,500 frames),
    the step under ``collectives.timing`` for its share, calls and bytes;
    then the short bf16 program of each (TPF_SHORT_LAYERS, on the kernels:
    a prefill, the loss and its gradients at S=4096) and its float32
    control (the plain path).

    The parent, alone on the card, holds them against the one-rank
    programs (``tpf_checks``), runs a Mamba-2 step over NCCL at world size
    1 (``tpf_nccl``), and reads the three configs' ``train_4k`` dry runs
    on the pod (``tpf_dry_runs``, a process of its own beside the ranks).
    It fails if a rank launches no SSD, RG-LRU or flash kernel of a
    family in the full or the short program (the SSD on its tensor-core
    route at (64, 128)), any FMA flash kernel in bf16, or the float32
    control any kernel; if a library loads more than once; or if the
    ranks' peaks sum over TPF_PEAK_GB.  Launches are the ranks' bf16
    prefill and train launches at full depth, summed."""
    import tempfile
    import torch.multiprocessing as mp
    from repro_torch.kernels.ssd import kernel as SK
    t0 = time.perf_counter()
    n = TP_MESH[0] * TP_MESH[1]
    dry_proc = tpf_dry_runs()
    with tempfile.TemporaryDirectory(prefix="tpf_") as tmp:
        ctx = mp.start_processes(tp_rank, args=(n, tmp, SEED, _tpf_rank),
                                 nprocs=n, join=False, start_method="spawn")
        try:
            join_ranks(ctx, TP_TIMEOUT, "tensor_parallel_families", tmp)
        except BaseException:
            dry_proc.kill()
            dry_proc.wait()
            raise
        ranks = []
        for r in range(n):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        t1 = time.perf_counter()
        checks = tpf_checks(tmp, ranks)
    t2 = time.perf_counter()
    nccl = tpf_nccl()
    t3 = time.perf_counter()
    dry = tpf_dry_records(dry_proc)
    launches = {}
    for r in ranks:
        for fam in r["families"].values():
            for k, v in fam["launches"].items():
                launches[k] = launches.get(k, 0) + v
    per = lambda key: {arch: [r["families"][arch][key] for r in ranks]  # noqa: E731
                       for arch in TPF_ARCHS}
    peaks = [max(f["peak_gb"] for f in r["families"].values())
             for r in ranks]
    emit("tensor_parallel_families", smi=smi, mesh=list(TP_MESH), ranks=n,
         device="cuda:0", transport="gloo: host (each collective staged "
         "through host memory)", batch=1, seq=TRAIN_SEQ,
         layers={a: tpf_config(a).n_layers for a in TPF_ARCHS},
         step_wall_ms=per("step_wall_ms"),
         collective_share=per("collective_share"),
         collective_calls=per("collective_calls"),
         collective_bytes=per("collective_bytes"),
         prefill_ms=per("prefill_ms"), peak_gb=per("peak_gb"),
         losses={a: ranks[0]["families"][a]["loss"] for a in TPF_ARCHS},
         launches_by_rank=[{a: r["families"][a]["launches"]
                            for a in TPF_ARCHS} for r in ranks],
         library_loads_by_rank=[r["library_loads"] for r in ranks],
         checks=checks, nccl=nccl, dry_runs_pod=dry,
         ranks_seconds=t1 - t0, checks_seconds=t2 - t1,
         nccl_seconds=t3 - t2, dry_run_seconds=time.perf_counter() - t3,
         seconds=time.perf_counter() - t0)
    fails = [a for a, v in checks.items() if not v["ok"]]
    if not nccl["ok"]:
        fails.append("nccl")
    if sum(peaks) > TPF_PEAK_GB:
        fails.append(f"the ranks' peaks sum to {sum(peaks):.2f} GB")
    if SK.route(torch.bfloat16, 64, 128) != "tc":
        fails.append("the SSD backward is not on its tensor-core route")
    for r in ranks:
        for arch, fam in r["families"].items():
            for lc in (fam["launches"], fam["short_launches"]):
                if any(lc[k] <= 0 for k in TPF_KERNELS[arch]) or any(
                        lc[k] for k in TPF_FMA):
                    fails.append(f"rank {r['rank']} {arch}: kernels {lc}")
            if any(fam["f32_launches"].values()):
                fails.append(f"rank {r['rank']} {arch}: the float32 "
                             f"control launched a kernel")
            if not (fam["prefill_finite"] and np.isfinite(fam["loss"])):
                fails.append(f"rank {r['rank']} {arch}: not finite")
        if any(v != 1 for v in r["library_loads"].values()):
            fails.append(f"rank {r['rank']} loads: {r['library_loads']}")
    if any(r["families"][a][k] != ranks[0]["families"][a][k]
           for r in ranks for a in TPF_ARCHS
           for k in ("loss", "short_loss")):
        fails.append("the ranks report different losses")
    for arch, rec in dry.items():
        if not (rec["flops_per_device"] > 0
                and rec["collective_bytes_per_device"] > 0):
            fails.append(f"{arch}: the pod dry run has no FLOPs or "
                         f"collectives")
    if fails:
        raise AssertionError(f"tensor_parallel_families: {fails}")
    return launches


# ----------------------------------------------------------------------
# the examples as python -m modules
# ----------------------------------------------------------------------
# (module, arguments, lines its output must hold)
EXAMPLES = (
    ("quickstart", (), ("cuda backend plan-identical: True",
                        "(transfer retraces during reconfig: 0)",
                        "transfer round-trip exact: True",
                        "bit-exact=True, spurious corrections=0")),
    ("paper_usecase", (), ("identical output: True",
                           "grants=[4, 16, 28] completions=[13, 25, 37]")),
    ("elastic_serving", (), ("request(s) admitted while earlier",
                             "-- A released")),
    ("elastic_serving", ("--steady-state",),
     ("1024 streams, 256 slots", "invalidation(s) from the")),
    ("moe_training", (), ("shell log: 1 events (0 watchdog timeouts)",)),
    ("moe_training", ("--sharded",), ("(zero per reconfiguration)",)),
)
EXAMPLE_TIMEOUT = {"moe_training": 600}
# run the module as ``python -m`` does (``runpy.run_module`` with
# ``alter_sys``), then write its kernel launches and library loads
_EXAMPLE_RUNNER = """
import json, runpy, sys
out, name = sys.argv[1], sys.argv[2]
sys.argv = [name, *sys.argv[3:]]
code = 0
try:
    runpy.run_module(name, run_name="__main__", alter_sys=True)
except SystemExit as e:
    code = e.code or 0
from repro_torch.kernels import build
from repro_torch.kernels.crossbar_dispatch import kernel as K
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.hamming import kernel as HK
from repro_torch.kernels.rglru import kernel as RK
from repro_torch.kernels.ssd import kernel as SK
with open(out, "w") as f:
    json.dump({"code": code, "loads": dict(build.load_count),
               "launches": {k: v for m in (FK, K, SK, RK, HK)
                            for k, v in m.launch_counts().items()}}, f)
sys.exit(code)
"""


def examples_phase(smi):
    """The four ``repro_torch.examples`` modules, each in a process of its
    own on the card as ``python -m repro_torch.examples.<name>`` runs it,
    all started together: quickstart, paper_usecase, elastic_serving (the
    lifecycle, and ``--steady-state``), moe_training at its defaults (300
    steps of the ~100M-parameter MoE, its convergence asserted;
    checkpoints into a temporary directory) and ``--sharded`` (4 gloo
    ranks on ``cuda:0``).  Each must exit 0, print the lines of
    ``EXAMPLES``, and load no library twice.  Launches are the modules'
    own processes' (the sharded demo's ranks are processes of their own:
    theirs are not counted); the seconds of each overlap the others'."""
    import tempfile
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (os.path.join(HERE, "src"),
                    os.environ.get("PYTHONPATH")) if p))
    launches, runs, fails = {}, [], []
    with tempfile.TemporaryDirectory(prefix="examples_") as tmp:
        procs = []
        for i, (name, args, want) in enumerate(EXAMPLES):
            training = name == "moe_training" and not args
            args = ["--ckpt", os.path.join(tmp, "ckpt")] if training \
                else list(args)
            rec_path = os.path.join(tmp, f"run{i}.json")
            procs.append((name, args, want, training, rec_path,
                          subprocess.Popen(
                              [sys.executable, "-c", _EXAMPLE_RUNNER,
                               rec_path, f"repro_torch.examples.{name}",
                               *args], cwd=HERE, env=env, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)))
        for name, args, want, training, rec_path, proc in procs:
            try:
                out, err = proc.communicate(
                    timeout=max(1.0, EXAMPLE_TIMEOUT.get(name, 300)
                                - (time.perf_counter() - t0)))
            except subprocess.TimeoutExpired:
                proc.kill()
                out, err = proc.communicate()
            lines = out.splitlines()
            run = {"module": name, "args": args, "rc": proc.returncode,
                   "read_at_s": time.perf_counter() - t0,
                   "tail": lines[-4:]}
            if proc.returncode == 0:
                with open(rec_path) as f:
                    rec = json.load(f)
                run.update(launches={k: v for k, v in rec["launches"].items()
                                     if v}, loads=rec["loads"])
                for k, v in rec["launches"].items():
                    launches[k] = launches.get(k, 0) + v
                if any(v != 1 for v in rec["loads"].values()):
                    fails.append(f"{name} {args}: loads {rec['loads']}")
                missing = [w for w in want
                           if not any(w in line for line in lines)]
                if missing:
                    fails.append(f"{name} {args}: no line with {missing}")
            else:
                fails.append(f"{name} {args}: exit {proc.returncode}: "
                             f"{err[-2000:]}")
            if training:
                run["losses"] = [ln for ln in lines if ln.startswith("loss ")]
            runs.append(run)
    emit("examples", smi=smi, runs=runs, launches=launches,
         seconds=time.perf_counter() - t0)
    if fails:
        raise AssertionError(f"examples: {fails}")
    return launches


def train_loop_config():
    """Mixtral-8x7B at its published widths cut to 1 of 32 layers (one
    checkpoint of (params, OptState) is some 17 GB), bf16, the MoE on the
    crossbar kernels."""
    from repro_torch.configs import get_config
    cfg = get_config("mixtral_8x7b")
    return dataclasses.replace(
        cfg, n_layers=1, dtype="bfloat16",
        moe=dataclasses.replace(cfg.moe, dispatch="cuda_kernel"))


def train_loop_phase(smi):
    """``TrainLoop.run_loop()`` on the 1-layer full-width Mixtral (S=4096,
    batch 1, lr 1e-3, warmup 1, 4 steps), with a one-tenant ``Shell``,
    ``region=0`` and ``StragglerStats``:

    - R: remat "nothing", no checkpoint;
    - A: remat "dots", checkpoints every 2 steps (keep 1) into a temporary
      directory; it crashes after its step-2 checkpoint (an exception from
      its step-2 log), as a failed node would.  A keeps R's 4-step config:
      the cosine schedule's length is ``steps``, so a 2-step run would take
      other learning rates than R's;
    - B: remat "dots", ``resume=True`` on A's directory.

    Every loss is finite; A's losses at steps 0-1 and B's at steps 2-3
    equal R's bit for bit; B starts at step 2 with the pipeline at step 2;
    B's restored leaves equal the files A wrote, bit for bit; no
    WatchdogTimeout; the crossbar and flash kernels launch; one library
    load.  Returns the launches of R, A and B together."""
    import shutil
    import tempfile
    from repro_torch.ckpt.checkpoint import host_leaves
    from repro_torch.core.elastic import Region
    from repro_torch.core.module import ModuleFootprint
    from repro_torch.kernels import build
    from repro_torch.models.common import tree_leaves
    from repro_torch.runtime import StragglerStats, TrainLoop, TrainLoopConfig
    from repro_torch.shell import Shell
    t0 = time.perf_counter()
    cfg = train_loop_config()
    run = TrainLoopConfig(steps=TRAIN_LOOP_STEPS, global_batch=1,
                          seq_len=TRAIN_SEQ, seed=SEED, lr=TRAIN_LR, warmup=1,
                          ckpt_every=2, ckpt_keep=1, log_every=1)
    shell = Shell([Region(rid=0, n_chips=1, hbm_bytes=80 * GB)])
    shell.submit("trainer", [ModuleFootprint(20 * GB, 6 * 1.7e9, 1 << 20)],
                 app_id=0)
    stats = StragglerStats(shell=shell)

    def loop(remat, **kw):
        gc.collect()                  # the previous run's tensors
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        return TrainLoop(dataclasses.replace(cfg, remat=remat), run,
                         shell=shell, region=0, straggler_stats=stats, **kw)

    def crash(rec):
        if rec["step"] == TRAIN_LOOP_CRASH:
            raise _Crash

    _reset_counts()
    runs = {}
    r = loop("nothing")
    runs["R"] = dict(hist=r.run_loop(),
                     peak=torch.cuda.max_memory_allocated())
    n_params = sum(p.numel() for p in tree_leaves(r.params))
    ckpt_bytes = n_params * (2 + 4 + 4) + 4     # bf16 params, f32 m and v
    del r
    root = tempfile.mkdtemp(prefix="train_loop_")
    try:
        free = shutil.disk_usage(root).free
        if free < 2 * ckpt_bytes:
            raise AssertionError(
                f"train_loop needs {2 * ckpt_bytes / 1e9:.1f} GB free for "
                f"its checkpoint, {root} has {free / 1e9:.1f} GB")
        a = loop("dots", ckpt_dir=root, on_log=crash)
        try:
            a.run_loop()
            raise AssertionError("run A did not crash")
        except _Crash:
            pass
        runs["A"] = dict(hist=a.history,
                         peak=torch.cuda.max_memory_allocated(),
                         snapshot_s=a.ckpt.last_snapshot_s,
                         write_s=a.ckpt.last_write_s)
        del a
        b = loop("dots", ckpt_dir=root, resume=True)
        restore_s = b.ckpt.last_restore_s
        start = (b.start_step, b.pipeline.state().step, b.opt_state.step)
        # B's leaves against the files A wrote, byte for byte
        d = os.path.join(root, f"step_{TRAIN_LOOP_CRASH:08d}")
        with open(os.path.join(d, "manifest.json")) as fh:
            manifest = json.load(fh)
        files = dict(zip(manifest["paths"], manifest["leaves"]))
        same_leaves = True
        for path, arr, _ in host_leaves((b.params, b.opt_state)):
            disk = np.load(os.path.join(d, files[path]["file"]),
                           mmap_mode="r")
            same_leaves &= (disk.shape == arr.shape and np.array_equal(
                disk.reshape(-1).view(np.uint8),
                arr.reshape(-1).view(np.uint8)))
        runs["B"] = dict(hist=b.run_loop(),
                         peak=torch.cuda.max_memory_allocated())
        del b
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launches = _counts()
    loads = dict(build.load_count)
    torch.cuda.empty_cache()
    losses = {k: [h["loss"] for h in v["hist"]] for k, v in runs.items()}
    steps = {k: [h["step"] for h in v["hist"]] for k, v in runs.items()}
    timeouts = [e.event for e in shell.log
                if type(e.event).__name__ == "WatchdogTimeout"]
    gb = ckpt_bytes / 1e9
    a_info = runs["A"]
    emit("train_loop", smi=smi, model=cfg.name, layers=cfg.n_layers,
         seq=TRAIN_SEQ, batch=1, lr=TRAIN_LR, steps=TRAIN_LOOP_STEPS,
         params=n_params, losses=losses, logged_steps=steps,
         step_wall_ms={k: [h["step_s"] * 1e3 for h in v["hist"]]
                       for k, v in runs.items()},
         max_memory_gb={"nothing": runs["R"]["peak"] / 1e9,
                        "dots": runs["A"]["peak"] / 1e9,
                        "dots_resumed": runs["B"]["peak"] / 1e9},
         checkpoint_gb=gb, disk_free_gb=free / 1e9,
         save_caller_s=a_info["snapshot_s"], save_background_s=a_info[
             "write_s"], restore_s=restore_s,
         save_caller_gb_per_s=gb / a_info["snapshot_s"],
         save_background_gb_per_s=gb / a_info["write_s"],
         restore_gb_per_s=gb / restore_s,
         resume={"start_step": start[0], "pipeline_step": start[1],
                 "opt_step": start[2]},
         restored_leaves_equal_files=bool(same_leaves),
         watchdog_timeouts=len(timeouts),
         straggler_scores=stats.scores(), kernels=launches,
         library_loads=loads, seconds=time.perf_counter() - t0)
    crash_at = TRAIN_LOOP_CRASH
    ok = {
        "finite": all(np.isfinite(v).all() for v in losses.values()),
        "A_equals_R": losses["A"] == losses["R"][:crash_at + 1],
        "B_equals_R": losses["B"] == losses["R"][crash_at:],
        "B_starts_at_the_checkpoint": start == (crash_at,) * 3
        and steps["B"] == list(range(crash_at, TRAIN_LOOP_STEPS)),
        "restored_leaves": bool(same_leaves),
        "no_watchdog_timeout": not timeouts,
        "kernels": all(launches[k] > 0 for k in TRAIN_KERNELS),
        "one_load": all(n == 1 for n in loads.values()),
    }
    if not all(ok.values()):
        raise AssertionError(f"train_loop: {ok}")
    check_flash_route(launches, cfg.dtype, "the train loop")
    _reset_counts()
    return launches


def serve_phase(cfg, smi):
    """The served run; returns the engine (its parameters are reused by
    the train phase) and the launches of exactly this run."""
    from repro_torch.kernels import build
    from repro_torch.kernels.crossbar_dispatch import kernel as K
    from repro_torch.models.common import tree_leaves
    from repro_torch.shell.server import ModelEngine
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab, PROMPT_LEN).astype(np.int32)
               for _ in range(4)]
    t0 = time.perf_counter()
    engine = ModelEngine(cfg, max_len=PROMPT_LEN + MAX_NEW, seed=SEED)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in tree_leaves(engine.params))
    emit("model", name=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
         d_ff=cfg.d_ff, experts=cfg.moe.n_experts, params=n_params,
         init_seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    engine.prefill(prompts[0])               # warm-up (cuBLAS, allocator)
    torch.cuda.synchronize()
    loads_before = build.load_count[K.LIB_NAME]
    K.reset_launch_counts()
    server, shell, wall = serve(engine, "cuda", prompts)
    launches = K.launch_counts()
    loads_after = build.load_count[K.LIB_NAME]
    comps = sorted(server.completions, key=lambda c: c.rid)
    tokens = sum(len(c.tokens) for c in comps)
    emit("serve", smi=smi, requests=len(comps), ticks=server.tick,
         wall_s=wall, tokens=tokens, tokens_per_s=tokens / wall,
         epoch=shell.epoch,
         completions=[{"rid": c.rid, "entry_port": c.entry_port,
                       "tokens": c.tokens} for c in comps],
         port_traffic=server.port_traffic.tolist(),
         offered=server.offered_packets, granted=server.granted_packets,
         kernels=launches, library_loads=loads_after,
         register_moves=server.fabric.register_moves)
    if len(comps) != 4 or any(len(c.tokens) != MAX_NEW for c in comps):
        raise AssertionError("not every request completed")
    if sorted({c.entry_port for c in comps}) != [0, 1]:
        raise AssertionError("the Grow did not re-route new admissions")
    if any(launches[k] <= 0 for k in SERVE_KERNELS):
        raise AssertionError(f"a kernel was not launched while serving: "
                             f"{launches}")
    if loads_before != 1 or loads_after != 1:
        raise AssertionError("the kernel library was loaded more than once")
    # the same requests through the plain versions on the card
    plain_cfg = dataclasses.replace(cfg, kernel_mode="torch")
    plain = ModelEngine(plain_cfg, max_len=PROMPT_LEN + MAX_NEW,
                        params=engine.params)
    ref_server, _, ref_wall = serve(plain, "reference", prompts)
    ref_comps = sorted(ref_server.completions, key=lambda c: c.rid)
    same_tokens = [c.tokens for c in comps] == [c.tokens for c in ref_comps]
    same_traffic = (server.port_traffic.tolist()
                    == ref_server.port_traffic.tolist())
    logits, _ = engine.model.decode_step(
        engine.params, engine.model.init_decode_state(1, 4),
        {"tokens": torch.tensor([[1]], dtype=torch.int32, device="cuda")})
    finite = bool(torch.isfinite(logits).all())
    emit("serve.check", plain_wall_s=ref_wall, same_tokens=same_tokens,
         same_port_traffic=same_traffic, logits_shape=list(logits.shape),
         logits_finite=finite, seconds=time.perf_counter() - t0)
    if not (same_tokens and same_traffic and finite
            and tuple(logits.shape) == (1, cfg.vocab_padded)):
        raise AssertionError("served output disagrees with the plain path")
    if "--profile" in sys.argv[1:]:
        tok, state = engine.prefill(prompts[0])
        for _ in range(2):
            tok, state = engine.decode(tok, state)

        def decode():
            nonlocal tok, state
            tok, state = engine.decode(tok, state)
        profile("serve.profile", decode, 8)
    return engine, launches


# ----------------------------------------------------------------------
# the control plane: the seeded serve harness, the manager's scenarios and
# the closed loop over the served Mixtral
# ----------------------------------------------------------------------
# ``benchmarks/serve_bench.py``'s two shapes (read, not imported): 2,048
# front-loaded streams through 1,024 slots, and heavy-tailed arrivals
# through 256 slots under a FailRegion / heal / Shrink / Grow script.
HARNESS_SEED = 11
STEADY_STREAMS, STEADY_SLOTS, STEADY_MAX_NEW = 2048, 1024, 48
STORM_STREAMS, STORM_SLOTS, STORM_GAP = 2048, 256, 0.1
STORM_TICKS = (20, 35, 50, 65)
# every ``ServeReport`` field that is a function of the seed alone
REPORT_INTS = ("n_streams", "n_slots", "ticks", "steady_ticks",
               "completions", "tokens", "reconfigs", "admission_p50_ticks",
               "admission_p99_ticks", "fabric_retraces", "plan_cache_hits",
               "plan_cache_misses", "plan_cache_invalidations",
               "token_digest")
SCENARIO_TICKS = 48
# the closed loop over the Mixtral tenant: a burst at tick 0, then quiet
LOOP_REQUESTS = 16
LOOP_TICKS = 72


def crossbar_loads() -> int:
    from repro_torch.kernels import build
    from repro_torch.kernels.crossbar_dispatch import kernel as K
    return build.load_count[K.LIB_NAME]


def harness_run(arrivals, *, plan_cache: bool, n_slots: int, storm: bool,
                backend: str, device):
    """One ``ServeHarness`` run over a fresh ``ElasticServer``: a 4-region
    shell with one 2-module tenant and a ``SeededEngine`` (serve_bench's
    server)."""
    from repro_torch.core.elastic import Region
    from repro_torch.core.module import ModuleFootprint
    from repro_torch.serve import ReconfigEvent, SeededEngine, ServeHarness
    from repro_torch.shell import Shell
    from repro_torch.shell.server import ElasticServer
    shell = Shell([Region(rid=i, n_chips=8, hbm_bytes=8 * GB)
                   for i in range(4)])
    shell.submit("svc", [ModuleFootprint(GB, 1e9, 4096)] * 2, app_id=0)
    server = ElasticServer(shell, n_slots=n_slots, plan_cache=plan_cache,
                           fabric_backend=backend, device=device)
    server.register_engine(0, SeededEngine(seed=HARNESS_SEED))
    script = ()
    if storm:
        a, b, c, d = STORM_TICKS
        script = [ReconfigEvent(a, lambda sh: sh.fail_region(2), "fail R2"),
                  ReconfigEvent(b, lambda sh: sh.heal_region(2), "heal R2"),
                  ReconfigEvent(c, lambda sh: sh.shrink("svc", 1), "shrink"),
                  ReconfigEvent(d, lambda sh: sh.grow("svc", 1), "grow")]
    return ServeHarness(server, arrivals, reconfigs=script).run(), server


def active_ticks(server) -> int:
    """Ticks on which some slot was active (a request decodes from its
    admission tick to its finishing tick, both included)."""
    return len({t for c in server.completions
                for t in range(c.admitted_tick, c.finished_tick + 1)})


def serve_harness_phase(smi):
    """``ServeHarness`` + ``SeededEngine`` over an ``ElasticServer`` on the
    ``cuda`` fabric on the card, at serve_bench's shapes: the steady state
    with the plan cache on and off, the storm with it on.  Each run is held
    to the same run on the ``reference`` backend on the CPU.  Returns the
    launches of the card runs."""
    from repro_torch.serve import front_loaded_arrivals, heavy_tailed_arrivals
    t0 = time.perf_counter()
    steady = front_loaded_arrivals(STEADY_STREAMS, seed=HARNESS_SEED,
                                   max_new=STEADY_MAX_NEW)
    bursty = heavy_tailed_arrivals(STORM_STREAMS, seed=HARNESS_SEED,
                                   mean_gap_ticks=STORM_GAP)
    runs = (("steady_cache_on", steady, True, STEADY_SLOTS, False),
            ("steady_cache_off", steady, False, STEADY_SLOTS, False),
            ("storm", bursty, True, STORM_SLOTS, True))
    launches = {}
    digests = {}
    for name, arrivals, cache, slots, storm in runs:
        kw = dict(plan_cache=cache, n_slots=slots, storm=storm)
        torch.cuda.synchronize()
        _reset_counts()
        report, server = harness_run(arrivals, backend="cuda", device=None,
                                     **kw)
        torch.cuda.synchronize()
        counts = _counts()
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        ref, ref_server = harness_run(arrivals, backend="reference",
                                      device="cpu", **kw)
        plans = counts["plan_multi"]
        want_plans = (report.plan_cache_misses if cache
                      else active_ticks(server))
        same = {f: getattr(report, f) == getattr(ref, f)
                for f in REPORT_INTS}
        same_traffic = (server.port_traffic.tolist()
                        == ref_server.port_traffic.tolist()
                        and (server.offered_packets, server.granted_packets)
                        == (ref_server.offered_packets,
                            ref_server.granted_packets))
        digests[name] = report.token_digest
        emit(f"serve_harness.{name}", smi=smi, streams=report.n_streams,
             slots=report.n_slots, ticks=report.ticks,
             steady_ticks=report.steady_ticks, tokens=report.tokens,
             completions=report.completions, reconfigs=report.reconfigs,
             wall_s=report.wall_s, tokens_per_s=report.tokens_per_s,
             tick_p50_us=report.tick_p50_us, tick_p99_us=report.tick_p99_us,
             steady_tick_p50_us=report.steady_tick_p50_us,
             steady_tick_p99_us=report.steady_tick_p99_us,
             admission_p50_ticks=report.admission_p50_ticks,
             admission_p99_ticks=report.admission_p99_ticks,
             plan_cache_hits=report.plan_cache_hits,
             plan_cache_misses=report.plan_cache_misses,
             plan_cache_invalidations=report.plan_cache_invalidations,
             fabric_retraces=report.fabric_retraces,
             trace_counts=server.fabric.trace_counts,
             plan_launches=plans, expected_plan_launches=want_plans,
             library_loads=crossbar_loads(),
             token_digest=report.token_digest,
             cpu_reference={"tokens_per_s": ref.tokens_per_s,
                            "tick_p50_us": ref.tick_p50_us,
                            "steady_tick_p50_us": ref.steady_tick_p50_us,
                            "same_as_card": same,
                            "same_port_traffic": same_traffic})
        if not (all(same.values()) and same_traffic):
            raise AssertionError(f"serve_harness {name} on the card "
                                 f"disagrees with the CPU reference: {same}")
        if report.completions != report.n_streams:
            raise AssertionError(f"serve_harness {name}: not every stream "
                                 f"completed")
        if (report.fabric_retraces != 1
                or server.fabric.trace_counts["plan"] != 1):
            raise AssertionError(f"serve_harness {name}: the plan ran under "
                                 f"{server.fabric.trace_counts} signatures")
        if crossbar_loads() != 1:
            raise AssertionError("the crossbar library was loaded twice")
        if not 0 < plans == want_plans:
            raise AssertionError(f"serve_harness {name}: {plans} plan "
                                 f"launches, not {want_plans}")
        if storm and not (report.reconfigs == len(STORM_TICKS)
                          == report.plan_cache_invalidations):
            raise AssertionError(f"serve_harness {name}: "
                                 f"{report.plan_cache_invalidations} cache "
                                 f"invalidations for {report.reconfigs} "
                                 f"posts")
    if digests["steady_cache_on"] != digests["steady_cache_off"]:
        raise AssertionError("the plan cache changed the token digest")
    emit("serve_harness", seconds=time.perf_counter() - t0,
         kernels=launches)
    return launches


def manager_scenarios_phase(smi):
    """``run_scenario`` on the card (``fabric_backend="cuda"``): bursty,
    production on a ``ServerPool`` of 4 servers over 24 regions, and the
    adversarial scenario under ``adversarial_policy``, each held row for
    row to the same call on ``reference`` on the CPU; production is also
    recorded on the card and replayed through ``RecordedWorkload``.
    Returns the launches of the three card runs."""
    from repro_torch.manager import scenarios
    t0 = time.perf_counter()
    out_dir = os.path.join(HERE, "build", "manager")
    os.makedirs(out_dir, exist_ok=True)
    runs = (("bursty", {}, None),
            ("production", {"n_regions": 24, "n_servers": 4}, None),
            ("adversarial", {}, "adversarial_policy"))
    launches = {}
    for kind, kw, policy in runs:
        def policy_kw():
            return ({} if policy is None
                    else {"policy": getattr(scenarios, policy)()})
        record = (os.path.join(out_dir, f"{kind}.jsonl")
                  if kind == "production" else None)
        torch.cuda.synchronize()
        _reset_counts()
        t1 = time.perf_counter()
        res = scenarios.run_scenario(kind, seed=SEED, ticks=SCENARIO_TICKS,
                                     fabric_backend="cuda",
                                     record_path=record, **kw, **policy_kw())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        counts = _counts()
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        got = res.to_json()
        t1 = time.perf_counter()
        want = scenarios.run_scenario(kind, seed=SEED, ticks=SCENARIO_TICKS,
                                      fabric_backend="reference",
                                      device="cpu", **kw,
                                      **policy_kw()).to_json()
        cpu_wall = time.perf_counter() - t1
        rows_equal = sum(a == b for a, b in zip(got["trace"], want["trace"]))
        replay_equal = None
        if record is not None:
            replay = scenarios.run_scenario(
                scenarios.RecordedWorkload.load(record),
                fabric_backend="cuda", **policy_kw())
            replay_equal = replay.to_json() == got
        emit(f"manager_scenarios.{kind}", smi=smi, seed=SEED,
             ticks=SCENARIO_TICKS, n_servers=res.n_servers,
             wall_s=wall, cpu_reference_wall_s=cpu_wall,
             decisions=len(res.decisions), events=res.event_counts,
             rejected_events=res.rejected_events,
             completions=res.completions, max_queue=res.max_queue,
             final_utilization=res.final_utilization,
             slo_violations=res.slo_violations,
             fabric_retraces=res.fabric_retraces,
             plan_launches=counts["plan_multi"],
             library_loads=crossbar_loads(),
             trace_rows_equal=rows_equal, same_as_cpu=got == want,
             replay_equal=replay_equal)
        if got != want:
            raise AssertionError(f"manager_scenarios {kind} on the card "
                                 f"disagrees with the CPU reference "
                                 f"({rows_equal} of {len(want['trace'])} "
                                 f"rows equal)")
        if replay_equal is False:
            raise AssertionError(f"the replayed {kind} trace differs")
        if crossbar_loads() != 1:
            raise AssertionError("the crossbar library was loaded twice")
        if counts["plan_multi"] <= 0:
            raise AssertionError(f"manager_scenarios {kind} launched no "
                                 f"plan kernel")
    emit("manager_scenarios", seconds=time.perf_counter() - t0,
         kernels=launches)
    return launches


def closed_loop(engine, fabric_backend: str, prompts):
    """The paper's resource manager over one served tenant: Mixtral with 4
    modules in a 4-region shell of 80 GB regions, started on 1 region;
    ``slots_per_region=1`` makes each region one decode slot, and a
    ``Hysteresis`` manager ticks once per server tick (deciding every
    second).  The burst at tick 0 grows the tenant; the quiet stretch after
    it shrinks it again.  Returns (server, manager, placed regions per
    tick, wall ms per tick, wall seconds)."""
    from repro_torch.core.elastic import Region
    from repro_torch.core.module import ModuleFootprint
    from repro_torch.manager import Hysteresis, Manager
    from repro_torch.shell import Shell, Shrink
    from repro_torch.shell.server import ElasticServer, StreamRequest
    shell = Shell([Region(rid=i, n_chips=8, hbm_bytes=80 * GB)
                   for i in range(4)])
    shell.submit("mixtral", [ModuleFootprint(7 * GB, 2 * 3.2e9, 8192)] * 4,
                 app_id=0)
    shell.post(Shrink("mixtral", 1))
    server = ElasticServer(shell, n_slots=N_SLOTS, slots_per_region=1,
                           fabric_backend=fabric_backend)
    server.register_engine(0, engine)
    manager = Manager(shell, Hysteresis(), probes=[server.probe()],
                      interval=2)
    for p in prompts:
        server.submit(StreamRequest(app_id=0, prompt=p, max_new=MAX_NEW))
    placed, tick_ms = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(LOOP_TICKS):
        t1 = time.perf_counter()
        server.step()
        manager.step()
        torch.cuda.synchronize()
        tick_ms.append((time.perf_counter() - t1) * 1e3)
        placed.append(shell.state.find_tenant("mixtral").placed_count)
    return server, manager, placed, tick_ms, time.perf_counter() - t0


def loop_decisions(manager):
    return [(d.tick, d.kinds(), [dataclasses.astuple(e) for e in d.events],
             dataclasses.asdict(d.signals), len(d.rejected))
            for d in manager.decisions]


def manager_mixtral_phase(engine, smi):
    """The closed loop on the served Mixtral (the serve phase's engine, MoE
    on ``cuda_kernel``, server fabric on ``cuda``), then on the plain path
    on the card: token streams and decisions equal, a Grow then a Shrink,
    the placed region count following them, library loads 1.  Returns the
    launches of the kernel run."""
    from repro_torch.shell.server import ModelEngine
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 2)
    prompts = [rng.integers(0, engine.cfg.vocab, PROMPT_LEN).astype(np.int32)
               for _ in range(LOOP_REQUESTS)]
    loads_before = crossbar_loads()
    _reset_counts()
    server, manager, placed, tick_ms, wall = closed_loop(engine, "cuda",
                                                         prompts)
    launches = _counts()
    plain = ModelEngine(dataclasses.replace(engine.cfg, kernel_mode="torch"),
                        max_len=engine.max_len, params=engine.params)
    ref_server, ref_manager, ref_placed, _, ref_wall = closed_loop(
        plain, "reference", prompts)
    comps = sorted(server.completions, key=lambda c: c.rid)
    ref_comps = sorted(ref_server.completions, key=lambda c: c.rid)
    same_tokens = ([(c.tokens, c.entry_port) for c in comps]
                   == [(c.tokens, c.entry_port) for c in ref_comps])
    decisions = loop_decisions(manager)
    same_decisions = decisions == loop_decisions(ref_manager)
    acted = [(d.tick, d.kinds()) for d in manager.decisions if d.events]
    kinds = [k for _, ks in acted for k in ks]
    follows = all(placed[t] - (placed[t - 1] if t else 1)
                  == ks.count("Grow") - ks.count("Shrink")
                  for t, ks in acted)
    # decode ticks: some slot active, nothing admitted on the tick
    busy = {t for c in comps for t in range(c.admitted_tick + 1,
                                            c.finished_tick + 1)}
    admits = {c.admitted_tick for c in comps}
    decode_ms = [tick_ms[t] for t in sorted(busy - admits)]
    tokens = sum(len(c.tokens) for c in comps)
    emit("manager_mixtral", smi=smi, model=engine.cfg.name,
         layers=engine.cfg.n_layers, requests=len(comps), ticks=LOOP_TICKS,
         tokens=tokens, wall_s=wall, tokens_per_s=tokens / wall,
         decode_tick_ms_p50=statistics.median(decode_ms),
         decode_tick_ms_max=max(decode_ms), decode_ticks=len(decode_ms),
         decisions=acted, placed_regions=placed,
         epoch=server.shell.epoch, same_tokens=same_tokens,
         same_decisions=same_decisions, placed_follows=follows,
         plain_wall_s=ref_wall, plain_placed_equal=placed == ref_placed,
         fabric_retraces=server.fabric.trace_count, kernels=launches,
         library_loads=crossbar_loads(), seconds=time.perf_counter() - t0)
    if len(comps) != LOOP_REQUESTS or any(len(c.tokens) != MAX_NEW
                                          for c in comps):
        raise AssertionError("manager_mixtral: not every request completed")
    if not (same_tokens and same_decisions and placed == ref_placed):
        raise AssertionError("manager_mixtral disagrees with the plain path")
    if not ("Grow" in kinds and "Shrink" in kinds[kinds.index("Grow"):]):
        raise AssertionError(f"the manager did not grow and then shrink the "
                             f"tenant: {acted}")
    if not follows or max(placed) <= 1:
        raise AssertionError(f"the placed regions do not follow the "
                             f"decisions: {placed}")
    if any(launches[k] <= 0 for k in SERVE_KERNELS):
        raise AssertionError(f"a kernel was not launched in the closed "
                             f"loop: {launches}")
    if loads_before != 1 or crossbar_loads() != 1:
        raise AssertionError("the crossbar library was loaded twice")
    return launches


# ----------------------------------------------------------------------
# the recurrent families: SSD, RG-LRU and flash attention at head dim 256
# ----------------------------------------------------------------------
# SSD is held to the plain chunked version (``ssd_chunked``) and, at a small
# S, to the sequential oracle (``ssd_ref``): float32 within 2e-4 of the
# chunked version (the same algebra summed in another order) and 5e-4 of
# the oracle (the JAX package's tolerance for its kernel); bfloat16 within
# 5e-2 element-wise and 1e-2 relative L2 (x, B, C rounded to bf16 and y
# rounded once, in both).  The final state within 5e-4 absolute and 5e-3
# relative in both types.
SSD_TOL = {torch.float32: 2e-4, torch.bfloat16: 5e-2}
# the bf16 forward at Mamba-2 780M's widths, one launch each a call: the
# chunk states and the outputs on wgmma, the carry between them
SSD_FWD_TC_KERNELS = ("state_wg_kernel", "pass_kernel<__nv_bfloat16>",
                      "out_wg_kernel")
# the bf16 backward at Mamba-2 780M's widths, one launch each a call: the
# forward's state pass (on x and B, and on dy and C for the dual states, in
# one launch), its carry and the carry of the gradient, the three row-tile
# passes on wgmma, then ddA and the sum over the head groups
SSD_BWD_TC_KERNELS = ("state_wg_kernel", "pass_kernel<__nv_bfloat16>",
                      "rpass_kernel<__nv_bfloat16>",
                      "dx_wg_kernel", "db_wg_kernel", "dc_wg_kernel",
                      "dda_kernel<64, 128, __nv_bfloat16>",
                      "head_sum_kernel<__nv_bfloat16>")
SSD_ORACLE_TOL = 5e-4
SSD_REL_L2 = 1e-2
# RG-LRU sums sequentially within tiles and composes the tiles in order:
# within 1e-5 of the oracle, and 5e-5 of the doubling scan (the JAX
# package's tolerance for its kernel); h in bf16 also within one bf16 ulp
# of |h| (2^-7 |h| bounds it) of the plain version's.
RGLRU_TOL = 5e-5
RGLRU_ORACLE_TOL = 1e-5
BF16_ULP = 2.0 ** -7
PREFILL_SEQ = 32768          # prefill_32k's sequence length; batch 32 -> 1
RECURRENT_F32_SEQ = 512      # the float32 check's prompt
MAMBA = dict(H=48, P=64, N=128, chunk=256)
RGEMMA = dict(L=4096, H=16, Kv=1, D=256, window=2048)
# The end-to-end bf16 S=32768 last-token logits of a full-depth random model
# are held within this many times a control measured in the same run: how
# far the plain path's own logits move under a difference of rounding size
# (``rounding_controls``).  Every block is held to ``PREFILL_REL`` besides.
PREFILL_CONTROL_FACTOR = 3.0


def ssd_inputs(B, S, H, P, N, dtype, gen):
    """Model-layout inputs of the SSD scan: x [B,S,H,P], dt [B,S,H],
    A [H], B and C [B,S,N]."""
    rn = lambda *s: torch.randn(s, generator=gen, device="cuda")
    x = rn(B, S, H, P).to(dtype)
    dt = torch.nn.functional.softplus(rn(B, S, H) - 2.0)
    A = -torch.exp(rn(H) * 0.5)
    return x, dt, A, (rn(B, S, N) * 0.3).to(dtype), \
        (rn(B, S, N) * 0.3).to(dtype)


def ssd_check(name, S, dtype, gen, oracle=False):
    """The kernel (``ssd_scan`` on CUDA) against ``ssd_chunked`` and, when
    asked, ``ssd_ref``; returns the largest absolute error."""
    from repro_torch.fabric.interface import KernelMode
    from repro_torch.kernels.ssd import ref as sref
    from repro_torch.kernels.ssd.ops import ssd_scan
    from repro_torch.models.ssm import ssd_chunked
    H, P, N, chunk = (MAMBA[k] for k in ("H", "P", "N", "chunk"))
    x, dt, A, Bm, Cm = ssd_inputs(1, S, H, P, N, dtype, gen)
    y, h = ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, mode=KernelMode.CUDA)
    yp, hp = ssd_chunked(x, dt, A, Bm, Cm, chunk)
    torch.cuda.synchronize()
    tol = SSD_TOL[dtype]
    res = {"y": within(y, yp, tol), "h_last": bool(torch.isclose(
        h.double(), hp.double(), atol=5e-4, rtol=5e-3).all())}
    rel = rel_l2(y, yp)
    if dtype == torch.bfloat16:
        res["y_rel_l2"] = rel <= SSD_REL_L2
    out = {"vs_chunked": max(max_abs_err(y, yp), max_abs_err(h, hp))}
    if oracle:
        dth = dt.transpose(1, 2)
        yo, ho = sref.ssd_ref(x.transpose(1, 2), dth * A[None, :, None],
                              dth, Bm, Cm)
        yo = yo.transpose(1, 2)
        torch.cuda.synchronize()
        res["oracle"] = (within(y, yo, SSD_ORACLE_TOL)
                         and within(h, ho, SSD_ORACLE_TOL))
        out["vs_oracle"] = max(max_abs_err(y, yo), max_abs_err(h, ho))
    emit("ssd.check", case=name, B=1, S=S, H=H, P=P, N=N, chunk=min(chunk, S),
         dtype=str(dtype).replace("torch.", ""), max_abs_err=out,
         rel_l2=rel, tol={"y": tol, "oracle": SSD_ORACLE_TOL,
                          "rel_l2": SSD_REL_L2}, **res)
    if not all(res.values()):
        raise AssertionError(f"SSD kernel disagrees on {name}: {res}")
    return max(out.values())


def ssd_phase():
    """SSD at Mamba-2 780M's widths: bf16 at S=4096 and 32768, float32 at
    S=1024 (also against the oracle), and S=200, below the chunk; timings
    at S=32768 bf16."""
    from repro_torch.fabric.interface import KernelMode
    from repro_torch.kernels.ssd import kernel as SK
    from repro_torch.kernels.ssd import ref as sref
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 3)
    bf16, f32 = torch.bfloat16, torch.float32
    err = max(ssd_check("mamba_4k", 4096, bf16, gen),
              ssd_check("mamba_32k", PREFILL_SEQ, bf16, gen),
              ssd_check("f32_1k", 1024, f32, gen, oracle=True),
              ssd_check("below_chunk_200", 200, f32, gen, oracle=True))
    H, P, N, Q = (MAMBA[k] for k in ("H", "P", "N", "chunk"))
    S = PREFILL_SEQ
    x, dt, A, Bm, Cm = ssd_inputs(1, S, H, P, N, bf16, gen)
    xh = x.transpose(1, 2).contiguous()
    dth = dt.transpose(1, 2).contiguous()
    dAh = dth * A[None, :, None]
    es = x.element_size()
    n_bytes = (2 * x.numel() * es + 2 * dth.numel() * 4
               + 2 * Bm.numel() * es + H * P * N * 4)
    nc = S // Q
    tri = Q * (Q + 1) // 2                     # causal half of a chunk
    n_ops = nc * (2 * tri * N                  # C.B^T, once per chunk
                  + H * (2 * tri * P           # G x
                         + 2 * 2 * Q * P * N))  # C.h and the state update
    b, by = bound(n_bytes, n_ops, roofline().PEAK_FLOPS)
    def kernel():
        return SK.ssd_call(xh, dAh, dth, Bm, Cm, chunk=Q, mode=KernelMode.CUDA)

    t = dict(ms=time_ms(kernel, reps=10),
             plain_ms=time_ms(lambda: sref.ssd_call_ref(xh, dAh, dth, Bm, Cm,
                                                        Q), reps=3),
             library_ms=None, bound_ms=b, bound_by=by, bytes=n_bytes,
             ops=n_ops)
    t["bound_share"] = t["bound_ms"] / t["ms"]
    route = SK.route(torch.bfloat16, P, N)
    _passes("ssd", t, kernel, route=route)
    emit("ssd.time", B=1, S=S, H=H, P=P, N=N, chunk=Q, dtype="bfloat16",
         route=route, **{k: v for k, v in t.items() if k != "passes"})
    names = sorted(p["name"] for p in t["passes"])
    if route != "tc" or names != sorted(SSD_FWD_TC_KERNELS):
        raise AssertionError(f"the bf16 SSD forward at (64, 128) launched "
                             f"{names}, not {sorted(SSD_FWD_TC_KERNELS)}")
    return err, t


def rglru_phase():
    """RG-LRU at RecurrentGemma-9B's width: the kernel against the
    doubling scan at B=1, S=32768, L=4096, against the oracle at S=4096,
    and through ``rglru_scan_kernel`` with an initial state against
    ``rglru_scan``; the model's entry on bf16 u and float32 a bit-equal to
    the float32 kernel on u.float() followed by the cast (with and without
    an initial state folded in first) and against the plain version on
    the same bf16 inputs, and one kernel a call; timings at S=32768."""
    from repro_torch.fabric.interface import KernelMode
    from repro_torch.kernels.rglru import kernel as RK
    from repro_torch.kernels.rglru import ref as rref
    from repro_torch.kernels.rglru.ops import rglru_scan_kernel
    from repro_torch.kernels.timing import device_profile
    from repro_torch.models.rglru import rglru_scan
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 4)
    L, S = RGEMMA["L"], PREFILL_SEQ
    rn = lambda *s: torch.randn(s, generator=gen, device="cuda")
    a = torch.sigmoid(rn(1, S, L) + 2.0) * 0.98 + 0.01
    b = rn(1, S, L) * 0.5
    cuda = KernelMode.CUDA
    h, hl = RK.rglru_call(a, b, mode=cuda)
    hp, hlp = rref.rglru_call_ref(a, b)
    ho, hlo = rref.rglru_ref(a[:, :4096], b[:, :4096])
    h0 = rn(1, L) * 0.3
    hk, hlk = rglru_scan_kernel(b, a, h0, mode=cuda)
    hs, hls = rglru_scan(b, a, h0)
    torch.cuda.synchronize()
    res = {"vs_scan": within(h, hp, RGLRU_TOL) and within(hl, hlp, RGLRU_TOL),
           "vs_oracle": within(h[:, :4096], ho, RGLRU_ORACLE_TOL),
           "with_h0": within(hk, hs, RGLRU_TOL) and within(hlk, hls,
                                                           RGLRU_TOL)}
    errs = {"vs_scan": max(max_abs_err(h, hp), max_abs_err(hl, hlp)),
            "vs_oracle": max_abs_err(h[:, :4096], ho),
            "with_h0": max(max_abs_err(hk, hs), max_abs_err(hlk, hls))}
    del hp, ho, hk, hs
    # the model's entry: u in bf16, h0 folded and h cast inside the kernel
    u = b.to(torch.bfloat16)
    entry_errs = {}
    for name, state in (("entry_bf16", None), ("entry_bf16_h0", h0)):
        he, hle = rglru_scan_kernel(u, a, state, mode=cuda)
        bf = u.float()
        if state is not None:
            bf = torch.cat([bf[:, :1] + a[:, :1] * state[:, None],
                            bf[:, 1:]], dim=1)
        hf, hlf = RK.rglru_call(a, bf, mode=cuda)
        torch.cuda.synchronize()
        res[name] = (torch.equal(he, hf.to(torch.bfloat16))
                     and torch.equal(hle, hlf))
        del hf, bf
        hp, hlp = rglru_scan(u, a, state)        # plain, on the same inputs
        torch.cuda.synchronize()
        diff = (he.double() - hp.double()).abs()
        res[name + "_vs_plain"] = (
            bool((diff <= RGLRU_TOL + BF16_ULP * hp.double().abs()).all())
            and within(hle, hlp, RGLRU_TOL))
        entry_errs[name + "_vs_plain"] = max(float(diff.max()),
                                             max_abs_err(hle, hlp))
        del he, hp, diff
    emit("rglru.check", B=1, S=S, L=L, dtype="float32", oracle_seq=4096,
         entry_dtypes={"u": "bfloat16", "a": "float32", "h": "bfloat16"},
         max_abs_err=errs, entry_max_abs_err=entry_errs,
         tol={"scan": RGLRU_TOL, "oracle": RGLRU_ORACLE_TOL,
              "entry": "bit-equal",
              "entry_vs_plain": f"{RGLRU_TOL} + {BF16_ULP} |h|"}, **res)
    if not all(res.values()):
        raise AssertionError(f"RG-LRU kernel disagrees: {res}")
    n_bytes = 3 * a.numel() * 4 + L * 4
    bnd, by = bound(n_bytes, 2 * a.numel(), roofline().PEAK_FLOPS_F32)
    entry = lambda: rglru_scan_kernel(u, a, mode=cuda)  # noqa: E731
    # a, u and h once each (4 + 2 + 2 bytes an element) and h_last
    entry_bound, _ = bound(8 * a.numel() + L * 4, 2 * a.numel(),
                           roofline().PEAK_FLOPS_F32)
    prof = device_profile(entry, calls=10, kernel="rglru_kernel")
    t = dict(ms=time_ms(lambda: RK.rglru_call(a, b, mode=cuda), reps=10),
             plain_ms=time_ms(lambda: rref.rglru_call_ref(a, b), reps=3),
             library_ms=None, bound_ms=bnd, bound_by=by, bytes=n_bytes,
             entry_ms=time_ms(entry, reps=10), entry_bound_ms=entry_bound,
             entry_device_ms=prof["device_ms"],
             kernels_per_call=prof["kernels"] + prof["memsets"],
             entry_kernels=prof["names"])
    emit("rglru.time", B=1, S=S, L=L, dtype="float32", **t)
    if t["kernels_per_call"] != 1:
        raise AssertionError(f"rglru_scan_kernel on bf16 u is not one "
                             f"kernel a call: {prof}")
    return max(errs.values()), t


def flash_d256_phase():
    """The flash forward at RecurrentGemma's attention shape (B=1, S=32768,
    H=16, Kv=1, D=256, window 2048, bf16, on the tensor-core kernel) against
    the plain version, run on query slices of 2048 rows with the keys they
    see (the whole [S, S] score matrix would take 68 GB); timed against the
    slices, against ``scaled_dot_product_attention`` with the window as a
    boolean mask (memory-efficient backend, kv head repeated for the 16
    query heads) and against the FMA kernel on the same inputs
    (``fma_ms``)."""
    from repro_torch.fabric.interface import KernelMode
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention import ref
    F = torch.nn.functional
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 5)
    S, H, Kv, D, W = PREFILL_SEQ, *(RGEMMA[k] for k in ("H", "Kv", "D",
                                                         "window"))
    mk = lambda *s: torch.randn(s, generator=gen, device="cuda").to(
        torch.bfloat16)
    q, k, v = mk(1, S, H, D), mk(1, S, Kv, D), mk(1, S, Kv, D)
    kw = dict(causal=True, window=W, q_offset=0)
    o, lse = FK.flash_fwd(q, k, v, mode=KernelMode.CUDA, **kw)

    def plain():
        outs = []
        for r0 in range(0, S, 2048):
            k0 = max(0, r0 - W + 1)
            outs.append(ref.attention_fwd_ref(
                q[:, r0:r0 + 2048], k[:, k0:r0 + 2048], v[:, k0:r0 + 2048],
                causal=True, window=W, q_offset=r0 - k0))
        return (torch.cat([x[0] for x in outs], 1),
                torch.cat([x[1] for x in outs], 2))

    o_r, lse_r = plain()
    torch.cuda.synchronize()
    dt = torch.bfloat16
    f_tol, rel_tol, lse_tol = (FLASH_TOL[dt][0], FLASH_REL_L2[dt],
                               FLASH_LSE_ABS[dt])
    rel, lse_err = rel_l2(o, o_r), lse_abs_err(lse, lse_r)
    ok = (within(o, o_r, f_tol) and rel <= rel_tol and lse_err <= lse_tol)
    err = max(max_abs_err(o, o_r), lse_err)
    tiles = H * flash_live_tiles(S, S, True, W, 0, torch.bfloat16, D)
    pairs = H * flash_live_pairs(S, S, True, W, 0)
    emit("flash_d256.check", B=1, S=S, H=H, Kv=Kv, D=D, window=W,
         dtype="bfloat16", live_tiles=tiles, live_pairs=pairs,
         max_abs_err=err, rel_l2=rel,
         lse_abs_err=lse_err, tol={"forward": f_tol, "rel_l2": rel_tol,
                                   "lse": lse_tol}, forward=ok)
    if not ok:
        raise AssertionError("flash forward at head dim 256 disagrees")
    del o_r, lse_r
    n_bytes = (2 * q.numel() + k.numel() + v.numel()) * 2 + H * S * 4
    b, by = bound(n_bytes, 4 * D * pairs, roofline().PEAK_FLOPS)
    hm = [t.transpose(1, 2).expand(1, H, S, D) if t.shape[2] == 1
          else t.transpose(1, 2) for t in (q, k, v)]
    hm = [t.contiguous() for t in hm]
    pos = torch.arange(S, device="cuda")
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - W)
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def library():
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return F.scaled_dot_product_attention(*hm, attn_mask=mask)

    t = dict(ms=time_ms(lambda: FK.flash_fwd(q, k, v, mode=KernelMode.CUDA,
                                             **kw), reps=5),
             plain_ms=time_ms(plain, reps=2, warmup=1),
             library_ms=time_ms(library, reps=5),
             bound_ms=b, bound_by=by,
             fma_ms=time_ms(lambda: FK.launch_fwd(q, k, v, kernel="fma",
                                                  **kw), reps=3, warmup=1))
    t["library_factor"] = t["ms"] / t["library_ms"]
    t["fma_factor"] = t["ms"] / t["fma_ms"]
    t["bound_share"] = t["bound_ms"] / t["ms"]
    emit("flash_d256.time", B=1, S=S, H=H, Kv=Kv, D=D, window=W,
         dtype="bfloat16", route=FK.route(torch.bfloat16, D), **t)
    return err, t


def published_config(arch, **kw):
    """``arch``'s published config in bf16, with ``kw`` replaced."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch), **{"dtype": "bfloat16",
                                                     **kw})


def smoke_widths_phase():
    """Every ported family's smoke config on the kernels against the plain
    path (``repro_torch.launch.smoke_widths``): the narrow widths that the
    full configs do not run.  Returns the launches of the kernel paths,
    summed over the configs."""
    from repro_torch.launch import smoke_widths
    t0 = time.perf_counter()
    launches = dict.fromkeys(_counts(), 0)
    bad = []
    for arch in smoke_widths.ARCHS:
        t1 = time.perf_counter()
        res = smoke_widths.check(arch, SEED)
        emit("smoke_widths.check", **res, seconds=time.perf_counter() - t1)
        for k, n in res["kernels"].items():
            launches[k] += n
        if not res["ok"]:
            bad.append(arch)
    emit("smoke_widths", kernels=launches, seconds=time.perf_counter() - t0)
    if bad:
        raise AssertionError(f"smoke configs disagree on the kernels: {bad}")
    _reset_counts()
    return launches


# the kernels each recurrent phase must launch on its main path
RECURRENT_KERNELS = {"mamba2_780m": ("plan_multi", "ssd"),
                     "recurrentgemma_9b": ("plan_multi", "rglru",
                                           "flash_fwd_d256")}


def serve_recurrent_phase(arch, phase, smi):
    """A full public model (every layer, bf16, random weights from the
    seed) behind ``ElasticServer`` on the ``cuda`` fabric, the requests and
    the ``Shell.post(Grow)`` of the Mixtral serve phase; then ``prefill``
    at S=32768, B=1.  Launches are counted over exactly the serve and the
    prefill.  Then the same requests and prefill on the plain path: token
    streams and port traffic equal, and each block of the bf16 prefill
    within ``PREFILL_REL`` of the plain path's on the same input
    (``blockwise_rel_l2``), and the end-to-end last-token logits within
    ``PREFILL_CONTROL_FACTOR`` times ``rounding_controls``: at full depth
    the random model carries a rounding-sized difference to a distance of
    the order of 1e-1 (PERF.md gives the readings), so a fixed limit would
    not hold, while a gross divergence still fails.  Then the float32
    check.  Returns the launches."""
    from repro_torch.models.common import tree_leaves
    from repro_torch.shell.server import ModelEngine
    cfg = published_config(arch)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab, PROMPT_LEN).astype(np.int32)
               for _ in range(4)]
    t0 = time.perf_counter()
    engine = ModelEngine(cfg, max_len=PROMPT_LEN + MAX_NEW, seed=SEED)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in tree_leaves(engine.params))
    emit(f"{phase}.model", name=cfg.name, family=cfg.family,
         layers=cfg.n_layers, d_model=cfg.d_model, params=n_params,
         param_bytes=n_params * 2, init_seconds=time.perf_counter() - t0)
    engine.prefill(prompts[0])               # warm-up (cuBLAS, allocator)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab, (1, PREFILL_SEQ)).astype(np.int32)).cuda()
    model, params = engine.model, engine.params
    with torch.no_grad():
        model.prefill(params, {"tokens": tokens[:, :2048]})   # warm-up
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    server, shell, wall = serve(engine, "cuda", prompts)
    serve_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    with torch.no_grad():
        logits = model.prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t1
    prefill_peak = torch.cuda.max_memory_allocated()
    launches = _counts()
    comps = sorted(server.completions, key=lambda c: c.rid)
    n_tok = sum(len(c.tokens) for c in comps)
    emit(phase, smi=smi, model=cfg.name, requests=len(comps),
         ticks=server.tick, wall_s=wall, tokens=n_tok,
         tokens_per_s=n_tok / wall, serve_max_memory_allocated=serve_peak,
         prefill_seq=PREFILL_SEQ, prefill_s=prefill_s,
         prefill_tokens_per_s=PREFILL_SEQ / prefill_s,
         prefill_max_memory_allocated=prefill_peak,
         completions=[{"rid": c.rid, "entry_port": c.entry_port,
                       "tokens": c.tokens} for c in comps],
         port_traffic=server.port_traffic.tolist(), kernels=launches,
         seconds=time.perf_counter() - t0)
    if len(comps) != 4 or any(len(c.tokens) != MAX_NEW for c in comps):
        raise AssertionError("not every request completed")
    if sorted({c.entry_port for c in comps}) != [0, 1]:
        raise AssertionError("the Grow did not re-route new admissions")
    missing = [k for k in RECURRENT_KERNELS[arch] if launches[k] <= 0]
    if missing:
        raise AssertionError(f"{phase}: not launched: {missing}")
    if "flash_fwd_d256" in RECURRENT_KERNELS[arch]:
        check_flash_route(launches, cfg.dtype, phase, ("flash_fwd_d256",))

    # the same requests and the same prefill on the plain path
    t0 = time.perf_counter()
    plain = ModelEngine(dataclasses.replace(cfg, kernel_mode="torch"),
                        max_len=PROMPT_LEN + MAX_NEW, params=params)
    ref_server, _, ref_wall = serve(plain, "reference", prompts)
    ref_comps = sorted(ref_server.completions, key=lambda c: c.rid)
    same_tokens = [c.tokens for c in comps] == [c.tokens for c in ref_comps]
    same_traffic = (server.port_traffic.tolist()
                    == ref_server.port_traffic.tolist())
    t1 = time.perf_counter()
    with torch.no_grad():
        ref_logits = plain.model.prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        plain_prefill_s = time.perf_counter() - t1
        control_name, control = rounding_controls(
            plain.model, params, {"tokens": tokens}, ref_logits)
        blocks = blockwise_rel_l2(model, plain.model, params,
                                  {"tokens": tokens})
    rel = rel_l2(logits.float(), ref_logits.float())
    finite = bool(torch.isfinite(logits).all())
    ok = (same_tokens and same_traffic and finite
          and max(blocks) <= PREFILL_REL
          and rel <= PREFILL_CONTROL_FACTOR * control
          and tuple(logits.shape) == (1, cfg.vocab_padded))
    emit(f"{phase}.check", plain_wall_s=ref_wall, same_tokens=same_tokens,
         same_port_traffic=same_traffic, prefill_finite=finite,
         prefill_shape=list(logits.shape), prefill_rel_l2=rel,
         control=control_name, control_rel_l2=control,
         prefill_tol=PREFILL_CONTROL_FACTOR * control,
         block_rel_l2_max=max(blocks),
         block_rel_l2=blocks, block_tol=PREFILL_REL,
         plain_prefill_s=plain_prefill_s, seconds=time.perf_counter() - t0)
    if not ok:
        raise AssertionError(f"{phase} disagrees with the plain path")
    if "--profile" in sys.argv[1:]:
        with torch.no_grad():
            profile(f"{phase}.prefill_profile",
                    lambda: model.prefill(params, {"tokens": tokens}), 1)
    del engine, plain, model, params, server, ref_server, logits, ref_logits
    torch.cuda.empty_cache()
    recurrent_f32_check(arch, phase)
    return launches


def blockwise_rel_l2(model, plain, params, batch):
    """Every block of the backbone, on the kernel path and on the plain
    path, fed the same input (the plain path's hidden state; an
    ``EncDecLM``'s decoder reads the plain path's encoder output): the
    relative L2 distance of the two blocks' contributions (output minus
    input), one per block, an encoder's first.  This holds every kernel
    call of the full-depth prefill at its real shape without the divergence
    that the random model's depth adds to the end-to-end logits (see
    ``rounding_controls``)."""
    from repro_torch.models.common import rms_norm
    cfg = model.cfg
    S = batch["tokens"].shape[1]
    pos = torch.arange(S, device=model.device)[None, :]
    out = []

    def run(pairs, x):
        for fn, plain_fn in pairs:
            y, y_plain = fn(x), plain_fn(x)
            out.append(rel_l2(y.float() - x.float(),
                              y_plain.float() - x.float()))
            x = y_plain
        return x

    if cfg.family == "encdec":
        x = batch["frames"].to(model.dtype)
        fpos = torch.arange(x.shape[1], device=model.device)[None, :]
        x = run([(functools.partial(model._enc_block, lp, positions=fpos),
                  functools.partial(plain._enc_block, lp, positions=fpos))
                 for lp in params["enc_layers"]], x)
        enc = rms_norm(x, params["enc_norm"], cfg.norm_eps)
        run([(functools.partial(model._dec_block, lp, enc=enc,
                                positions=pos),
              functools.partial(plain._dec_block, lp, enc=enc,
                                positions=pos))
             for lp in params["dec_layers"]],
            model._embed(params, batch["tokens"]))
    elif hasattr(model, "blocks"):
        run(zip(model.blocks(params, S), plain.blocks(params, S)),
            model._inputs_embed(params, batch))
    else:
        dense = lambda m, lp: lambda x: m._block(lp, x, pos, 1024)[0]  # noqa: E731
        run([(dense(model, lp), dense(plain, lp))
             for lp in params["layers"]], model._inputs_embed(params, batch))
    return out


@torch.no_grad()
def moe_block_halves(model, plain, params, batch, moe_group: int = 1024):
    """Each block of a MoE ``DenseLM`` fed the plain path's hidden state x,
    split at its two halves: (a) the attention half's contribution, kernel
    vs plain path on x; (b) the MoE half's output, kernel vs plain path,
    fed the same normed residual (the plain path's); (c) the share of
    tokens whose top-k expert set differs between the router on the two
    paths' own residuals; (d) the whole block's contribution, kernel vs
    plain (``blockwise_rel_l2``'s reading), and its control: the plain
    block fed x moved by one bf16 ulp, against the plain block on x.
    Returns one dict a block."""
    from repro_torch.models import attention as A
    from repro_torch.models.common import rms_norm
    cfg = model.cfg
    S = batch["tokens"].shape[1]
    pos = torch.arange(S, device=model.device)[None, :]
    x = model._inputs_embed(params, batch)
    out = []
    for lp in params["layers"]:
        def attention(m):
            h = rms_norm(x, lp["norm1"], cfg.norm_eps)
            q, k, v = m._qkv(lp["attn"], h, pos)
            o = A.attention_prefill(q, k, v, causal=True,
                                    window=cfg.attn_window,
                                    kernel_mode=m.cfg.kernel_mode)
            return x + m._attn_out(o, lp["attn"]["wo"])

        a_k, a_p = attention(model), attention(plain)
        h_k = rms_norm(a_k, lp["norm2"], cfg.norm_eps)
        h_p = rms_norm(a_p, lp["norm2"], cfg.norm_eps)
        m_k, m_p = model._ffn(lp, h_p, moe_group)[0], \
            plain._ffn(lp, h_p, moe_group)[0]
        experts = [(h @ lp["moe"]["w_router"]).float().topk(
            cfg.moe.top_k, dim=-1).indices.sort(dim=-1).values
            for h in (h_k, h_p)]
        flips = float((experts[0] != experts[1]).any(-1).float().mean())
        y_k = model._block(lp, x, pos, moe_group)[0]
        y_p = plain._block(lp, x, pos, moe_group)[0]
        x_n = (x.view(torch.int16) + 1).view(x.dtype)
        y_n = plain._block(lp, x_n, pos, moe_group)[0]
        out.append({"attention": rel_l2(a_k.float() - x.float(),
                                        a_p.float() - x.float()),
                    "moe_same_input": rel_l2(m_k.float(), m_p.float()),
                    "expert_set_flips": flips,
                    "block": rel_l2(y_k.float() - x.float(),
                                    y_p.float() - x.float()),
                    "control_block": rel_l2(y_n.float() - x_n.float(),
                                            y_p.float() - x.float())})
        x = y_p
    return out


def rounding_controls(plain_model, params, batch, ref_logits):
    """How far the plain path's own last-token logits move under a
    difference of the size of bf16 rounding, the scale of divergence that
    the random model's depth gives any two computations that round
    differently.  Returns (name, relative L2): for the SSM ``other_chunk``,
    the plain SSD scan at chunk 128 instead of 256 (the same function
    summed in another order, as the kernel sums it); for the other families
    ``one_ulp``, every element of the last token's embedding row moved by
    one bf16 ulp (restored after)."""
    cfg = plain_model.cfg
    if cfg.ssm is not None:
        other = type(plain_model)(dataclasses.replace(
            cfg, ssm=dataclasses.replace(cfg.ssm, chunk=cfg.ssm.chunk // 2)),
            device=plain_model.device)
        return "other_chunk", rel_l2(
            other.prefill(params, batch).float(), ref_logits.float())
    bits = params["embed"][int(batch["tokens"][0, -1])].view(torch.int16)
    bits += 1
    try:
        nudged = plain_model.prefill(params, batch)
    finally:
        bits -= 1
    return "one_ulp", rel_l2(nudged.float(), ref_logits.float())


def recurrent_f32_check(arch, phase):
    """A float32 copy of the model at full width, cut to its first 2
    layers (the hybrid to 3: one whole group, two recurrent blocks and the
    local-attention block), TF32 off: ``prefill`` logits and the ``loss``
    value on the kernel path against the plain path within 1e-4 relative
    (the scans sum in other orders), and ``prefill``'s greedy token equal
    to the token ``ModelEngine`` gets by replaying the same 512-token
    prompt through ``decode_step`` (the scan against the recurrence)."""
    from repro_torch.runtime.serve import greedy_tokens
    from repro_torch.shell.server import ModelEngine
    t0 = time.perf_counter()
    layers = 3 if arch == "recurrentgemma_9b" else 2
    cfg = published_config(arch, n_layers=layers, dtype="float32")
    engine = ModelEngine(cfg, max_len=RECURRENT_F32_SEQ, seed=SEED + 1)
    model, params = engine.model, engine.params
    plain = type(model)(dataclasses.replace(cfg, kernel_mode="torch"))
    rng = np.random.default_rng(SEED + 1)
    prompt = rng.integers(0, cfg.vocab, RECURRENT_F32_SEQ).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, RECURRENT_F32_SEQ).astype(np.int32)
    batch = {"tokens": torch.from_numpy(prompt[None]).cuda(),
             "labels": torch.from_numpy(labels[None]).cuda()}
    out = {}
    with torch.no_grad():
        for name, m in (("kernel", model), ("plain", plain)):
            _reset_counts()
            out[name] = (m.prefill(params, batch), float(m.loss(params, batch)),
                         _counts())
    replay_tok, _ = engine.prefill(prompt)
    torch.cuda.synchronize()
    (lk, loss_k, ck), (lp, loss_p, cp) = out["kernel"], out["plain"]
    rel = rel_l2(lk, lp)
    tok = int(greedy_tokens(lk, cfg.vocab)[0])
    path = [k for k in RECURRENT_KERNELS[arch] if k != "plan_multi"]
    ok = (rel <= F32_REL and abs(loss_k - loss_p) <= F32_REL * abs(loss_p)
          and tok == replay_tok and all(ck[k] > 0 for k in path)
          and not any(cp.values()))
    emit(f"{phase}.f32_check", layers=layers, seq=RECURRENT_F32_SEQ,
         prefill_rel_l2=rel, loss_kernel=loss_k, loss_plain=loss_p,
         tol=F32_REL, prefill_token=tok, replay_token=replay_tok,
         kernel_launches=ck, plain_launches=cp,
         seconds=time.perf_counter() - t0)
    if not ok:
        raise AssertionError(f"{phase}: float32 prefill, loss or the "
                             f"replayed token disagree")
    if "flash_fwd_d256" in path:
        check_flash_route(ck, "float32", f"{phase}.f32_check",
                          ("flash_fwd_d256",))
    del engine, model, params
    torch.cuda.empty_cache()


# ----------------------------------------------------------------------
# the recurrent families' backward kernels, and training them
# ----------------------------------------------------------------------
# Each backward kernel against its plain version (``ssd_bwd_ref``,
# ``rglru_bwd_ref``, ``attention_bwd_ref``) and against autograd through the
# plain forward, on the same inputs: every gradient within BWD_REL_L2 (the
# forward's ``SSD_REL_L2`` and ``FLASH_REL_L2`` in bf16), dh0 with an
# initial state; two calls bit-equal.
BWD_REL_L2 = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# train cells: the layers kept at published widths, and the float32 check's
TRAIN_LAYERS = {"mamba2_780m": 48, "recurrentgemma_9b": 6}   # hybrid: 2 groups
TRAIN_F32_LAYERS = {"mamba2_780m": 2, "recurrentgemma_9b": 3}
# the forward and backward kernels each train cell must launch
TRAIN_RECURRENT_KERNELS = {
    "mamba2_780m": ("ssd", "ssd_bwd"),
    "recurrentgemma_9b": ("rglru", "rglru_bwd", "flash_fwd_d256",
                          "flash_bwd_d256")}


def _grad_check(name, dtype, got, again, plain, autograd, names, **shape):
    """The kernel's gradients ``got`` (and a second call's ``again``)
    against the plain version's and autograd's; returns the largest
    absolute error against the plain version."""
    tol = BWD_REL_L2[dtype]
    rel = {n: rel_l2(a, b) for n, a, b in zip(names, got, plain)}
    rel_ag = {n: rel_l2(a, b) for n, a, b in zip(names, got, autograd)}
    same_types = all(a.dtype == b.dtype and a.shape == b.shape
                     for a, b in zip(got, plain))
    bits = all(torch.equal(a, b) for a, b in zip(got, again))
    err = max(max_abs_err(a, b) for a, b in zip(got, plain))
    res = {"vs_plain": max(rel.values()) <= tol,
           "vs_autograd": max(rel_ag.values()) <= tol,
           "types": same_types, "bit_equal": bits}
    emit(f"{name}.check", dtype=str(dtype).replace("torch.", ""), **shape,
         rel_l2=rel, rel_l2_autograd=rel_ag, tol=tol, max_abs_err=err, **res)
    if not all(res.values()):
        raise AssertionError(f"{name} disagrees: {res}")
    return err


def _autograd(fn, inputs, cots):
    """Gradients of ``fn(*inputs)`` for ``cots`` by autograd."""
    leaves = [t.detach().requires_grad_() for t in inputs]
    with torch.enable_grad():
        return torch.autograd.grad(fn(*leaves), leaves, cots)


def _passes(name, t, fn, **kw) -> None:
    """Add the device ms of each kernel a call of ``fn`` launches
    (``passes``), their sum (``device_ms``) and the kernels a call to the
    timings ``t``, and emit them as ``<name>.passes``."""
    from repro_torch.kernels.timing import kernel_split
    t["passes"] = kernel_split(fn)
    t["device_ms"] = sum(r["device_ms"] for r in t["passes"])
    t["kernels_per_call"] = sum(r["launches_per_call"] for r in t["passes"])
    emit(f"{name}.passes", device_ms=t["device_ms"],
         kernels_per_call=t["kernels_per_call"], passes=t["passes"], **kw)


def ssd_bwd_phase(gen):
    """The SSD backward at Mamba-2 780M's train shape (B=1, S=4096, H=48,
    P=64, N=128, chunk 256), bf16 and float32, with an initial state and a
    cotangent of h_last; timed in bf16, and its passes' device ms from one
    profiled window (``ssd_bwd.passes``)."""
    from repro_torch.fabric.interface import KernelMode
    from repro_torch.kernels.ssd import kernel as SK
    from repro_torch.kernels.ssd import ref as sref
    H, P, N, Q = (MAMBA[k] for k in ("H", "P", "N", "chunk"))
    S = TRAIN_SEQ
    rn = lambda *s: torch.randn(s, generator=gen, device="cuda")  # noqa: E731
    names = ("dx", "ddA", "ddt", "dB", "dC", "dh0")
    err, t = 0.0, None
    for dtype in (torch.bfloat16, torch.float32):
        x, dt, A, Bm, Cm = ssd_inputs(1, S, H, P, N, dtype, gen)
        xh = x.transpose(1, 2).contiguous()
        dth = dt.transpose(1, 2).contiguous()
        dAh = dth * A[None, :, None]
        h0, dhl = rn(1, H, P, N) * 0.3, rn(1, H, P, N)
        dy = rn(1, H, S, P).to(dtype)
        args = (xh, dAh, dth, Bm, Cm, dy)
        kw = dict(chunk=Q, h0=h0, dh_last=dhl)

        def kernel():
            return SK.ssd_call_bwd(*args, mode=KernelMode.CUDA, **kw)

        got, again = kernel(), kernel()
        plain = sref.ssd_bwd_ref(*args, Q, h0, dhl)
        ag = _autograd(lambda *a: sref.ssd_call_ref(*a[:5], Q, a[5]),
                       (xh, dAh, dth, Bm, Cm, h0), (dy, dhl))
        torch.cuda.synchronize()
        err = max(err, _grad_check("ssd_bwd", dtype, got, again, plain, ag,
                                   names, B=1, S=S, H=H, P=P, N=N, chunk=Q))
        del got, again, plain, ag
        if dtype != torch.bfloat16:
            continue
        es = x.element_size()
        # x, dy, dx; B, C, dB, dC; dA, dt, ddA, ddt; h0, dh_last, dh0
        n_bytes = (3 * x.numel() * es + 4 * Bm.numel() * es
                   + 4 * dth.numel() * 4 + 3 * H * P * N * 4)
        nc, tri = S // Q, Q * (Q + 1) // 2
        n_ops = nc * (2 * tri * N                       # C.B^T
                      + H * (4 * tri * P                # G dy, dy.x
                             + 4 * tri * N              # D C, D B
                             + 10 * Q * P * N))         # states, g B, x g,
        #                                                 dy h_in, dual states
        b, by = bound(n_bytes, n_ops, roofline().PEAK_FLOPS)
        t = dict(ms=time_ms(kernel, reps=10),
                 plain_ms=time_ms(lambda: sref.ssd_bwd_ref(*args, Q, h0, dhl),
                                  reps=3),
                 library_ms=None, bound_ms=b, bound_by=by, bytes=n_bytes,
                 ops=n_ops)
        t["bound_share"] = t["bound_ms"] / t["ms"]
        route = SK.route(dtype, P, N)
        _passes("ssd_bwd", t, kernel, route=route)
        emit("ssd_bwd.time", B=1, S=S, H=H, P=P, N=N, chunk=Q,
             dtype="bfloat16", route=route,
             **{k: v for k, v in t.items() if k != "passes"})
        launched = sorted(p["name"] for p in t["passes"])
        if (route != "tc" or launched != sorted(SSD_BWD_TC_KERNELS)
                or t["kernels_per_call"] != len(SSD_BWD_TC_KERNELS)):
            raise AssertionError(
                f"the bf16 SSD backward at (64, 128) launched {launched} "
                f"({t['kernels_per_call']} a call), not "
                f"{sorted(SSD_BWD_TC_KERNELS)} once each")
    return err, t


def rglru_bwd_phase(gen):
    """The RG-LRU backward at RecurrentGemma-9B's train shape (B=1,
    S=4096, L=4096): bf16 u (the model's) and float32, with an initial
    state and a cotangent of h_last, from the forward kernel's saved
    carries; timed in bf16."""
    from repro_torch.fabric.interface import KernelMode
    from repro_torch.kernels.rglru import kernel as RK
    from repro_torch.kernels.rglru import ref as rref
    L, S = RGEMMA["L"], TRAIN_SEQ
    rn = lambda *s: torch.randn(s, generator=gen, device="cuda")  # noqa: E731
    cuda = KernelMode.CUDA
    err, t = 0.0, None
    for dtype in (torch.bfloat16, torch.float32):
        a = torch.sigmoid(rn(1, S, L) + 2.0) * 0.98 + 0.01
        u = (rn(1, S, L) * 0.5).to(dtype)
        h0, dhl = rn(1, L) * 0.3, rn(1, L)
        dh = rn(1, S, L).to(dtype)
        _, _, carries = RK.rglru_scan(u, a, h0, mode=cuda, save_carries=True)

        def kernel():
            return RK.rglru_scan_bwd(u, a, h0, dh, dhl, carries, mode=cuda)

        def scan(uu, aa, hh):
            h, h_last = rref.rglru_call_ref(aa, uu.float(), hh)
            return h.to(uu.dtype), h_last

        got, again = kernel(), kernel()
        plain = rref.rglru_bwd_ref(u, a, h0, dh, dhl)
        ag = _autograd(scan, (u, a, h0), (dh, dhl))
        torch.cuda.synchronize()
        err = max(err, _grad_check("rglru_bwd", dtype, got, again, plain, ag,
                                   ("du", "da", "dh0"), B=1, S=S, L=L))
        del got, again, plain, ag
        if dtype != torch.bfloat16:
            continue
        # a, u, dh read; du, da written; the carries; h0, dh_last, dh0
        n_bytes = (a.numel() * (4 + 2 + 2 + 2 + 4) + carries.numel() * 4
                   + 3 * L * 4)
        b, by = bound(n_bytes, 4 * a.numel(), roofline().PEAK_FLOPS_F32)
        t = dict(ms=time_ms(kernel, reps=10),
                 plain_ms=time_ms(lambda: rref.rglru_bwd_ref(u, a, h0, dh,
                                                             dhl), reps=3),
                 library_ms=None, bound_ms=b, bound_by=by, bytes=n_bytes)
        t["bound_share"] = t["bound_ms"] / t["ms"]
        _passes("rglru_bwd", t, kernel, chunk_tiles=RK.BWD_CHUNK_TILES)
        emit("rglru_bwd.time", B=1, S=S, L=L, dtype="bfloat16",
             **{k: v for k, v in t.items() if k != "passes"})
    return err, t


def flash_d256_bwd_phase(gen):
    """The flash backward at head dim 256 at RecurrentGemma's train shape
    (B=1, S=4096, H=16, Kv=1, window 2048): bf16 on the tensor-core
    kernels and float32 on the FMA ones, each against autograd through
    ``attention_ref`` (``FlashCase.check``) and bit-equal twice; timed in
    bf16 against the plain version, ``scaled_dot_product_attention``'s
    backward with the window as a boolean mask (memory-efficient backend,
    the kv head repeated for the 16 query heads) and the FMA kernels on the
    same inputs (``fma_ms``)."""
    from repro_torch.fabric.interface import KernelMode
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention import ref
    from torch.nn.attention import SDPBackend, sdpa_kernel
    F = torch.nn.functional
    cuda = KernelMode.CUDA
    S, H, Kv, D, W = TRAIN_SEQ, *(RGEMMA[k] for k in ("H", "Kv", "D",
                                                       "window"))
    err, t = 0.0, None
    for dtype in (torch.bfloat16, torch.float32):
        case = FlashCase(f"d256_train_{str(dtype)[6:]}", 1, S, S, H, Kv, D,
                         dtype, True, W, gen)
        err = max(err, case.check()[1])
        q, k, v, do = case.q, case.k, case.v, case.do
        o, lse = FK.flash_fwd(q, k, v, mode=cuda, **case.kw)

        def kernel():
            return FK.flash_bwd(q, k, v, o, lse, do, mode=cuda, **case.kw)

        got, again = kernel(), kernel()
        torch.cuda.synchronize()
        bits = all(torch.equal(a, b) for a, b in zip(got, again))
        route = FK.route(dtype, D, backward=True)
        emit("flash_d256_bwd.check", dtype=str(dtype)[6:], route=route,
             bit_equal=bits)
        if not bits:
            raise AssertionError("the flash backward at head dim 256 is not "
                                 "deterministic")
        del got, again
        if dtype != torch.bfloat16:
            continue
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        out = ref.attention_ref(*leaves, **case.kw)
        hm = [x.transpose(1, 2).expand(1, H, S, D).contiguous()
              .requires_grad_() for x in (q, k, v)]
        pos = torch.arange(S, device="cuda")
        mask = (pos[None, :] <= pos[:, None]) & (pos[None, :]
                                                 > pos[:, None] - W)
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            lib_out = F.scaled_dot_product_attention(*hm, attn_mask=mask)
        do_hm = do.transpose(1, 2).contiguous()
        io = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        b, by = bound(2 * io + H * S * 4, 2.5 * 4 * D * case.pairs,
                      roofline().PEAK_FLOPS)
        t = dict(ms=time_ms(kernel, reps=10),
                 plain_ms=time_ms(lambda: torch.autograd.grad(
                     out, leaves, do, retain_graph=True), reps=3),
                 library_ms=time_ms(lambda: torch.autograd.grad(
                     lib_out, hm, do_hm, retain_graph=True), reps=5),
                 bound_ms=b, bound_by=by,
                 fma_ms=time_ms(lambda: FK.launch_bwd(
                     q, k, v, o, lse, do, kernel="fma", **case.kw), reps=3,
                     warmup=1))
        t["library_factor"] = t["ms"] / t["library_ms"]
        t["fma_factor"] = t["ms"] / t["fma_ms"]
        t["bound_share"] = t["bound_ms"] / t["ms"]
        _passes("flash_d256_bwd", t, kernel, route=route,
                head_groups=len(FK.head_groups(H // Kv)))
        emit("flash_d256_bwd.time", B=1, S=S, H=H, Kv=Kv, D=D, window=W,
             dtype="bfloat16", route=route, live_pairs=case.pairs,
             **{k: v for k, v in t.items() if k != "passes"})
        del out, lib_out, leaves, hm
    return err, t


def recurrent_bwd_phase():
    """The three backward kernels of the recurrent families (built in phase
    2 with the others)."""
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 6)
    out = {"ssd_bwd": ssd_bwd_phase(gen), "rglru_bwd": rglru_bwd_phase(gen),
           "flash_bwd_d256": flash_d256_bwd_phase(gen)}
    torch.cuda.empty_cache()
    emit("recurrent_bwd", seconds=time.perf_counter() - t0)
    return out


def recurrent_train_phase(arch, phase, smi):
    """``make_train_step`` with AdamW on a recurrent model at its published
    widths (Mamba-2 780M whole; RecurrentGemma-9B cut to 2 of its 12 groups,
    its 38-block model and AdamW's moments exceeding the card), bf16, random
    weights from the seed, remat "dots", on one batch of ``train_4k`` cut to
    B=1 (S=4096; the hybrid's window of 2048 binds).  Step 1's loss and
    every gradient leaf under remat "nothing" equal "dots"'s bit for bit;
    then 3 steps: losses finite, the 3rd below the 1st, the forward and
    backward kernels launched over exactly these steps, each block's
    backward once a step on its kernel (so no plain backward ran).  Then
    the float32 check.  Returns the steps' launches."""
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.launch.steps import _value_and_grad, make_train_step
    from repro_torch.models.common import tree_leaves, tree_nbytes
    from repro_torch.models.lm import build_model
    from repro_torch.optim.adamw import AdamW
    t0 = time.perf_counter()
    cfg = published_config(arch, n_layers=TRAIN_LAYERS[arch])
    if cfg.remat != "dots":
        raise AssertionError(f"{arch} does not default to remat dots")
    model = build_model(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    params = model.init(gen)
    n_params = sum(p.numel() for p in tree_leaves(params))
    batch = {k: torch.from_numpy(v).cuda() for k, v in synthetic_batch(
        SEED, 0, 0, 1, 1, TRAIN_SEQ, cfg.vocab).items()}
    # step 1's gradients, remat "dots" against "nothing"
    nothing = type(model)(dataclasses.replace(cfg, remat="nothing"))
    peaks, grads = {}, {}
    for name, m in (("dots", model), ("nothing", nothing)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        grads[name] = _value_and_grad(m, params, batch)
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated()
    (ld, gd), (ln, gn) = grads["dots"], grads["nothing"]
    remat_equal = (torch.equal(ld, ln) and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(gd), tree_leaves(gn))))
    del grads, gd, gn, nothing
    if cfg.family == "ssm":
        blocks = cfg.n_layers
    else:
        blocks = {"rec": model.n_groups * cfg.hybrid.pattern_rec
                  + model.n_trail, "attn": model.n_groups}
    # three AdamW steps
    opt = AdamW(lr=TRAIN_LR)
    step = make_train_step(model, opt)
    state = opt.init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    losses, walls = [], []
    for _ in range(TRAIN_STEPS):
        t1 = time.perf_counter()
        params, state, loss = step(params, state, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t1) * 1e3)
        losses.append(float(loss))
    launches = _counts()
    peak = torch.cuda.max_memory_allocated()
    MEASURED[phase] = {"max_memory_allocated": peak,
                       "param_bytes": tree_nbytes(params),
                       "opt_state_bytes": tree_nbytes([state.m, state.v])}
    if cfg.family == "ssm":
        want = {"ssd_bwd": blocks * TRAIN_STEPS}
    else:
        want = {"rglru_bwd": blocks["rec"] * TRAIN_STEPS,
                "flash_bwd_d256": blocks["attn"] * TRAIN_STEPS}
    emit(phase, smi=smi, model=cfg.name, layers=cfg.n_layers,
         d_model=cfg.d_model, params=n_params, batch=1, seq=TRAIN_SEQ,
         remat=cfg.remat, lr=TRAIN_LR, losses=losses, step_wall_ms=walls,
         max_memory_allocated=peak, max_memory_gb=peak / 1e9,
         step1_peak_gb={k: v / 1e9 for k, v in peaks.items()},
         remat_nothing_equal=remat_equal, kernels=launches,
         backward_launches_expected=want, seconds=time.perf_counter() - t0)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{phase}: a loss is not finite: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{phase}: the loss did not fall: {losses}")
    if not remat_equal:
        raise AssertionError(f"{phase}: remat dots and nothing disagree")
    missing = [k for k in TRAIN_RECURRENT_KERNELS[arch] if launches[k] <= 0]
    if missing or any(launches[k] != n for k, n in want.items()):
        raise AssertionError(f"{phase}: kernels {launches}, backward "
                             f"launches wanted {want}")
    if cfg.family == "hybrid":
        check_flash_route(launches, cfg.dtype, phase,
                          ("flash_fwd_d256", "flash_bwd_d256"))
    if "--profile" in sys.argv[1:]:
        profile(f"{phase}.profile", lambda: step(params, state, batch), 1)
    del state, params, model, step
    torch.cuda.empty_cache()
    recurrent_train_f32_check(arch, phase)
    return launches


def recurrent_train_f32_check(arch, phase):
    """A float32 copy cut to 2 layers (the hybrid to one group, 3 blocks)
    at S=4096: ``train_f32_check``."""
    from repro_torch.data.pipeline import synthetic_batch
    cfg = published_config(arch, n_layers=TRAIN_F32_LAYERS[arch],
                           dtype="float32")
    batch = {k: torch.from_numpy(v).cuda() for k, v in synthetic_batch(
        SEED, 1, 0, 1, 1, TRAIN_SEQ, cfg.vocab).items()}
    flash = ("flash_fwd_d256", "flash_bwd_d256") if cfg.family == "hybrid" \
        else ()
    train_f32_check(phase, cfg, batch, TRAIN_RECURRENT_KERNELS[arch], flash)


def train_f32_check(phase, cfg, batch, path, flash=()):
    """The float32 model ``cfg`` on ``batch``, TF32 off: the loss and every
    gradient leaf on the kernels within ``F32_REL`` of the leaf's largest
    value of the plain path (the same arithmetic summed in other orders),
    every leaf nonzero, the kernels ``path`` launched on the kernel path
    and none on the plain one, and the flash wrappers ``flash`` on the FMA
    route only."""
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.lm import build_model
    t0 = time.perf_counter()
    model = build_model(cfg)
    plain = type(model)(dataclasses.replace(cfg, kernel_mode="torch"))
    gen = torch.Generator(device=model.device)
    gen.manual_seed(SEED + 1)
    params = model.init(gen)
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    out = {}
    for name, m in (("kernel", model), ("plain", plain)):
        _reset_counts()
        loss = m.loss(params, batch)
        out[name] = (float(loss.detach()), torch.autograd.grad(loss, leaves),
                     _counts())
        del loss
    torch.cuda.synchronize()
    (lk, gk, ck), (lp, gp, cp) = out["kernel"], out["plain"]
    rel = [float((a - b).abs().max() / b.abs().max()) for a, b in zip(gk, gp)]
    nonzero = all(float(a.abs().max()) > 0 for a in gk)
    emit(f"{phase}.f32_check", layers=cfg.n_layers,
         encoder_layers=cfg.n_encoder_layers, seq=batch["tokens"].shape[1],
         params=sum(p.numel() for p in leaves), loss_kernel=lk,
         loss_plain=lp, grad_leaves=len(rel), grad_rel_max=max(rel),
         tol=F32_REL, grads_nonzero=nonzero, kernel_launches=ck,
         plain_launches=cp, seconds=time.perf_counter() - t0)
    if not (abs(lk - lp) <= F32_REL * abs(lp) and max(rel) <= F32_REL
            and nonzero and all(ck[k] > 0 for k in path)
            and not any(cp.values())):
        raise AssertionError(f"{phase}: float32 loss or gradients disagree "
                             f"with the plain path")
    if flash:
        check_flash_route(ck, "float32", f"{phase}.f32_check", flash)
    del out, gk, gp, params, leaves, model, plain
    torch.cuda.empty_cache()


# ----------------------------------------------------------------------
# the encoder-decoder (Whisper-medium) and the vision-language model
# (LLaVA-NeXT-34B): serve, prefill and train
# ----------------------------------------------------------------------
# Whisper's config names no decoder length: its decoder takes train_4k's
# 4,096 tokens against the 1,500 encoder frames
ENCDEC_SEQ = TRAIN_SEQ
VLM_SEQ = TRAIN_SEQ          # the first 2,880 positions are patches
VLM_TRAIN_LAYERS = 2         # of 60: AdamW's float32 moments of all 60
                             # would take 275 GB
ENCDEC_F32_LAYERS = 2        # encoder and decoder layers of the f32 check
INPUT_STD = 0.02             # frames and patches, as the JAX package's tests
# LLaVA-NeXT's published learning rate for its LLM in fine-tuning: at
# d = 7168 lr 1e-3 overshoots by the 3rd step on the plain path as well
# (``repro_torch.launch.loss_seeds --arch llava_next_34b``; PERF.md)
VLM_TRAIN_LR = 2e-5
FAMILY_PHASE_KERNELS = ("flash_fwd", "flash_bwd")


def family_input(cfg, rng):
    """The encoder-decoder's frames [1, F, d] or the vlm's patches
    [1, Pn, d], drawn from N(0, 0.02) with ``rng``, in the model's type on
    the card; nothing for the dense and moe families."""
    from repro_torch.models.common import dtype_of
    if cfg.family in ("dense", "moe"):
        return {}
    name, rows = {"encdec": ("frames", cfg.encoder_len),
                  "vlm": ("patches", cfg.n_vision_patches)}[cfg.family]
    x = rng.normal(0, INPUT_STD, (1, rows, cfg.d_model)).astype(np.float32)
    return {name: torch.from_numpy(x).cuda().to(dtype_of(cfg.dtype))}


class AttentionKinds:
    """While active, counts the flash forward launches of every
    ``attention_prefill`` call by kind and route: ``causal``,
    ``bidirectional`` (not causal, Sq = Sk: the encoder) and ``cross`` (not
    causal, Sq != Sk).  The models reach ``attention_prefill`` through the
    module, so the count wraps it there; the wrappers' own counts are
    untouched."""

    def __enter__(self):
        from repro_torch.kernels.flash_attention import kernel as FK
        from repro_torch.models import attention as A
        self.calls = {k: {"calls": 0, "tc": 0, "fma": 0}
                      for k in ("causal", "bidirectional", "cross")}
        inner = self._inner = A.attention_prefill

        def counted(q, k, v, *, causal=True, **kw):
            before = FK.launch_counts()
            out = inner(q, k, v, causal=causal, **kw)
            after = FK.launch_counts()
            kind = "causal" if causal else (
                "bidirectional" if q.shape[1] == k.shape[1] else "cross")
            c = self.calls[kind]
            c["calls"] += 1
            for r in ("tc", "fma"):
                c[r] += after[f"flash_fwd_{r}"] - before[f"flash_fwd_{r}"]
            return out

        A.attention_prefill = counted
        return self

    def __exit__(self, *exc):
        from repro_torch.models import attention as A
        A.attention_prefill = self._inner
        return False


@dataclasses.dataclass(frozen=True)
class DenseCell:
    """One of the dense family's published configs on the card at its
    widths: the name of its cells in ``launch_cells``, the layers its
    serve and prefill cell runs (``None``: all of them), the prefill
    length, the layers its train cell runs (``None``: all), whether the
    dry run decides that cell first (``train_if_fits``: run only if
    ``dryrun.run_cell`` predicts a fit, else recorded as predicted not
    to) and the MoE's dispatch.  Widths are never cut."""
    arch: str
    short: str
    serve_layers: int | None = None
    prefill_seq: int = TRAIN_SEQ
    train_layers: int | None = None
    train_if_fits: bool = False
    dispatch: str | None = None

    def overrides(self, layers) -> dict:
        """``published_config``'s overrides for a cell of ``layers``."""
        from repro_torch.configs import get_config
        out = {} if layers is None else {"n_layers": layers}
        if self.dispatch is not None:
            moe = get_config(self.arch).moe
            out["moe"] = dataclasses.replace(moe, dispatch=self.dispatch)
        return out

    def config(self, layers):
        return published_config(self.arch, **self.overrides(layers))


# ROADMAP B20: the four published dense-family configs that ran on the card
# only at smoke widths.  Mixtral-8x22B's 56 layers and Command R+'s 64 are
# cut to 8 for serve and prefill (41 and 31.5 GB of bf16); Mixtral-8x22B
# prefills at S=8192, so that its window of 4096 cuts half of the keys, and
# its MoE runs on the crossbar kernels as the served Mixtral-8x7B's does.
# One layer of Command R+ holds 4.72 B parameters (the tied 256000 x 12288
# embedding is 3.15 B): its AdamW state alone is 56.6 GB, so the dry run
# decides whether its train cell runs.
DENSE_CELLS = (
    DenseCell("qwen2_5_3b", "qwen"),
    DenseCell("granite_3_2b", "granite"),
    DenseCell("mixtral_8x22b", "mixtral22", serve_layers=8,
              prefill_seq=2 * TRAIN_SEQ, train_layers=1,
              dispatch="cuda_kernel"),
    DenseCell("command_r_plus_104b", "command_r", serve_layers=8,
              train_layers=1, train_if_fits=True),
)
QKV_BIAS_STD = INPUT_STD


@torch.no_grad()
def draw_qkv_biases(params, seed: int) -> None:
    """Qwen's ``bq``/``bk``/``bv``, which both inits leave at zero, drawn
    in place from N(0, 0.02) with ``seed``: the kernel path and the plain
    path share the tensors, so both carry them."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    for lp in params["layers"]:
        for name in ("bq", "bk", "bv"):
            b = lp["attn"][name]
            b.copy_(QKV_BIAS_STD * torch.randn(b.shape, generator=gen,
                                               device="cuda"))


def serve_family_phase(arch, phase, smi, cell=None):
    """A public model at its published widths (Whisper-medium whole,
    LLaVA-NeXT-34B at all 60 layers; a ``DenseCell``'s config cut to its
    serve layers), bf16, random weights from the seed (Qwen's QKV biases
    drawn, ``draw_qkv_biases``),
    behind ``ElasticServer`` on the ``cuda`` fabric with the serve phase's
    requests and ``Shell.post(Grow)``; then ``prefill`` at S=4096, B=1 with
    1,500 frames or 2,880 patches from N(0, 0.02) (a dense cell: tokens
    only, at its prefill length).  Launches are counted
    over exactly the serve and the prefill, and the prefill's flash
    launches by kind (``AttentionKinds``); a MoE cell must also launch
    the crossbar kernels.  Then the same on the plain
    path: token streams and port traffic equal, every block within
    ``PREFILL_REL`` (``blockwise_rel_l2``; a MoE model's blocks by
    ``moe_block_halves``: each half on the same input within
    ``PREFILL_REL``, each whole block within it or else within
    ``PREFILL_CONTROL_FACTOR`` times its one-ulp control), and the
    last-token logits
    within ``PREFILL_REL``, or else within ``PREFILL_CONTROL_FACTOR`` times
    the same run's one-ulp control (``rounding_controls``); the line names
    the limit that held.  Returns the launches."""
    from repro_torch.configs import get_config
    from repro_torch.models.common import tree_leaves, tree_nbytes
    from repro_torch.shell.server import ModelEngine
    cfg = published_config(arch) if cell is None else cell.config(
        cell.serve_layers)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab, PROMPT_LEN).astype(np.int32)
               for _ in range(4)]
    t0 = time.perf_counter()
    engine = ModelEngine(cfg, max_len=PROMPT_LEN + MAX_NEW, seed=SEED)
    model, params = engine.model, engine.params
    if cfg.qkv_bias:
        draw_qkv_biases(params, SEED)
    torch.cuda.synchronize()
    n_params = model.n_params()
    held = sum(p.numel() for p in tree_leaves(params))
    emit(f"{phase}.model", name=cfg.name, family=cfg.family,
         layers=cfg.n_layers, published_layers=get_config(arch).n_layers,
         encoder_layers=cfg.n_encoder_layers,
         d_model=cfg.d_model, heads=cfg.n_heads, kv_heads=cfg.n_kv_heads,
         head_dim=cfg.hd, d_ff=cfg.d_ff, vocab=cfg.vocab,
         window=cfg.attn_window, qkv_bias=cfg.qkv_bias,
         tied_embeddings=cfg.tied_embeddings,
         moe_dispatch=cfg.moe.dispatch if cfg.moe else None,
         n_params=n_params, params_held=held,
         param_bytes=held * 2, param_gb=held * 2 / 1e9,
         memory_allocated_gb=torch.cuda.memory_allocated() / 1e9,
         init_seconds=time.perf_counter() - t0)
    if n_params != held:
        raise AssertionError(f"n_params {n_params} but {held} held")
    seq = (cell.prefill_seq if cell is not None else
           ENCDEC_SEQ if cfg.family == "encdec" else VLM_SEQ)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (1, seq)).astype(np.int32)).cuda(),
        **family_input(cfg, rng)}
    engine.prefill(prompts[0])               # warm-up (cuBLAS, allocator)
    with torch.no_grad():
        model.prefill(params, {k: v[:, :1024] if k == "tokens" else v
                               for k, v in batch.items()})
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    server, shell, wall = serve(engine, "cuda", prompts)
    serve_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    with torch.no_grad(), AttentionKinds() as kinds:
        logits = model.prefill(params, batch)
        torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t1
    prefill_peak = torch.cuda.max_memory_allocated()
    launches = _counts()
    MEASURED[phase] = {"max_memory_allocated": prefill_peak,
                       "param_bytes": tree_nbytes(params), "opt_state_bytes": 0}
    comps = sorted(server.completions, key=lambda c: c.rid)
    n_tok = sum(len(c.tokens) for c in comps)
    # (query, key) pairs a head that the prefill's attention needs: the
    # window cuts keys where it is shorter than the sequence
    pairs = {"live": flash_live_pairs(seq, seq, True, cfg.attn_window, 0),
             "causal": seq * (seq + 1) // 2}
    emit(phase, smi=smi, model=cfg.name, layers=cfg.n_layers,
         published_layers=get_config(arch).n_layers, requests=len(comps),
         ticks=server.tick, wall_s=wall, tokens=n_tok,
         tokens_per_s=n_tok / wall, serve_max_memory_allocated=serve_peak,
         serve_max_memory_gb=serve_peak / 1e9, prefill_seq=seq,
         prefill_inputs={k: list(v.shape) for k, v in batch.items()},
         prefill_s=prefill_s, prefill_tokens_per_s=seq / prefill_s,
         prefill_max_memory_allocated=prefill_peak,
         prefill_max_memory_gb=prefill_peak / 1e9,
         flash_by_kind=kinds.calls, window=cfg.attn_window,
         flash_live_pairs=pairs,
         **({"cross_cache": "zero, as in the JAX package: served tokens "
                            "do not depend on the frames"}
            if cfg.family == "encdec" else {}),
         completions=[{"rid": c.rid, "entry_port": c.entry_port,
                       "tokens": c.tokens} for c in comps],
         port_traffic=server.port_traffic.tolist(), kernels=launches,
         seconds=time.perf_counter() - t0)
    if len(comps) != 4 or any(len(c.tokens) != MAX_NEW for c in comps):
        raise AssertionError("not every request completed")
    if sorted({c.entry_port for c in comps}) != [0, 1]:
        raise AssertionError("the Grow did not re-route new admissions")
    want = {"causal": cfg.n_layers, "bidirectional": cfg.n_encoder_layers,
            "cross": cfg.n_layers if cfg.family == "encdec" else 0}
    got = {k: c["tc"] for k, c in kinds.calls.items()}
    if got != want or any(c["fma"] for c in kinds.calls.values()):
        raise AssertionError(f"{phase}: flash launches by kind {kinds.calls}"
                             f", wanted {want} on the tc route")
    if launches["flash_fwd"] != sum(want.values()):
        raise AssertionError(f"{phase}: kernels {launches}")
    check_flash_route(launches, cfg.dtype, phase, ("flash_fwd",))
    if cfg.moe is not None and any(launches[k] <= 0 for k in SERVE_KERNELS):
        raise AssertionError(f"{phase}: the MoE launched no crossbar "
                             f"kernel: {launches}")

    # the same requests and the same prefill on the plain path
    t0 = time.perf_counter()
    plain = ModelEngine(dataclasses.replace(cfg, kernel_mode="torch"),
                        max_len=PROMPT_LEN + MAX_NEW, params=params)
    ref_server, _, ref_wall = serve(plain, "reference", prompts)
    ref_comps = sorted(ref_server.completions, key=lambda c: c.rid)
    same_tokens = [c.tokens for c in comps] == [c.tokens for c in ref_comps]
    same_traffic = (server.port_traffic.tolist()
                    == ref_server.port_traffic.tolist())
    t1 = time.perf_counter()
    with torch.no_grad():
        ref_logits = plain.model.prefill(params, batch)
        torch.cuda.synchronize()
        plain_prefill_s = time.perf_counter() - t1
        control_name, control = rounding_controls(plain.model, params,
                                                  batch, ref_logits)
        if cfg.moe is None:
            blocks = blockwise_rel_l2(model, plain.model, params, batch)
            halves = None
        else:
            halves = moe_block_halves(model, plain.model, params, batch)
            blocks = [h["block"] for h in halves]
    rel = rel_l2(logits.float(), ref_logits.float())
    finite = bool(torch.isfinite(logits).all())
    limit = ("rel_l2" if rel <= PREFILL_REL else
             "control" if rel <= PREFILL_CONTROL_FACTOR * control else None)
    if halves is None:
        blocks_ok, moe_blocks = max(blocks) <= PREFILL_REL, {}
    else:
        # top-k routing is discontinuous: a rounding-sized difference
        # flips some tokens' experts, so a MoE block is held by its halves
        # on the same input, and as a whole by its own one-ulp control
        # (moe_block_halves; ROADMAP C)
        held = ["rel_l2" if h["block"] <= PREFILL_REL else
                "control" if h["block"] <= PREFILL_CONTROL_FACTOR
                * h["control_block"] else None for h in halves]
        half_max = max(max(h["attention"], h["moe_same_input"])
                       for h in halves)
        blocks_ok = half_max <= PREFILL_REL and None not in held
        moe_blocks = {"block_halves": halves, "block_half_max": half_max,
                      "block_limit_held": held}
    ok = (same_tokens and same_traffic and finite and limit is not None
          and blocks_ok and tuple(logits.shape) == (1, cfg.vocab_padded))
    emit(f"{phase}.check", plain_wall_s=ref_wall, same_tokens=same_tokens,
         same_port_traffic=same_traffic, prefill_finite=finite,
         prefill_shape=list(logits.shape), prefill_rel_l2=rel,
         prefill_tol=PREFILL_REL, control=control_name,
         control_rel_l2=control,
         control_tol=PREFILL_CONTROL_FACTOR * control, limit_held=limit,
         block_rel_l2_max=max(blocks), block_rel_l2=blocks,
         block_tol=PREFILL_REL, **moe_blocks,
         plain_prefill_s=plain_prefill_s, seconds=time.perf_counter() - t0)
    if not ok:
        raise AssertionError(f"{phase} disagrees with the plain path")
    if "--profile" in sys.argv[1:]:
        with torch.no_grad():
            profile(f"{phase}.prefill_profile",
                    lambda: model.prefill(params, batch), 1)
    del engine, plain, model, params, server, ref_server, logits, ref_logits
    torch.cuda.empty_cache()
    return launches


def train_family_phase(arch, phase, smi, layers=None, lr=TRAIN_LR,
                       cell=None):
    """``make_train_step`` with AdamW (lr 1e-3 unless ``lr`` says) on a
    public model at its
    published widths (``layers`` of them, all by default; a ``DenseCell``'s
    train layers and dispatch), bf16, remat
    "dots", random weights from the seed (Qwen's QKV biases drawn): 3 steps
    on one batch of
    ``train_4k`` cut to B=1 (S=4096) with 1,500 frames or 2,880 patches.
    Losses finite and the 3rd below the 1st; exactly one flash backward a
    step per attention call (Whisper: 24 encoder, 24 decoder and 24 cross;
    LLaVA and the dense cells: one a layer), all on the tensor-core route;
    a MoE cell also launches the crossbar kernels.  Returns the steps'
    launches."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.common import tree_nbytes
    from repro_torch.models.lm import build_model
    from repro_torch.optim.adamw import AdamW
    t0 = time.perf_counter()
    if cell is not None:
        cfg = cell.config(cell.train_layers)
    else:
        cfg = published_config(arch,
                               **({"n_layers": layers} if layers else {}))
    if cfg.remat != "dots":
        raise AssertionError(f"{arch} does not default to remat dots")
    model = build_model(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    params = model.init(gen)
    if cfg.qkv_bias:
        draw_qkv_biases(params, SEED)
    batch = {k: torch.from_numpy(v).cuda() for k, v in synthetic_batch(
        SEED, 0, 0, 1, 1, TRAIN_SEQ, cfg.vocab).items()}
    batch.update(family_input(cfg, np.random.default_rng(SEED)))
    opt = AdamW(lr=lr)
    step = make_train_step(model, opt)
    state = opt.init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    losses, walls = [], []
    for _ in range(TRAIN_STEPS):
        t1 = time.perf_counter()
        params, state, loss = step(params, state, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t1) * 1e3)
        losses.append(float(loss))
    launches = _counts()
    peak = torch.cuda.max_memory_allocated()
    MEASURED[phase] = {"max_memory_allocated": peak,
                       "param_bytes": tree_nbytes(params),
                       "opt_state_bytes": tree_nbytes([state.m, state.v])}
    calls = cfg.n_encoder_layers + cfg.n_layers * (
        2 if cfg.family == "encdec" else 1)
    want = {"flash_bwd": calls * TRAIN_STEPS,
            "flash_bwd_tc": calls * TRAIN_STEPS}
    want_more = SERVE_KERNELS if cfg.moe is not None else ()
    emit(phase, smi=smi, model=cfg.name, layers=cfg.n_layers,
         published_layers=get_config(arch).n_layers,
         encoder_layers=cfg.n_encoder_layers, d_model=cfg.d_model,
         n_params=model.n_params(), batch=1, seq=TRAIN_SEQ,
         inputs={k: list(v.shape) for k, v in batch.items()},
         remat=cfg.remat, lr=lr, losses=losses, step_wall_ms=walls,
         max_memory_allocated=peak, max_memory_gb=peak / 1e9,
         param_bytes=MEASURED[phase]["param_bytes"],
         opt_state_bytes=MEASURED[phase]["opt_state_bytes"],
         kernels=launches, backward_launches_expected=want,
         seconds=time.perf_counter() - t0)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{phase}: a loss is not finite: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{phase}: the loss did not fall: {losses}")
    if any(launches[k] != n for k, n in want.items()) \
            or launches["flash_fwd"] <= 0 \
            or any(launches[k] <= 0 for k in want_more):
        raise AssertionError(f"{phase}: kernels {launches}, backward "
                             f"launches wanted {want} and {want_more}")
    check_flash_route(launches, cfg.dtype, phase)
    if "--profile" in sys.argv[1:]:
        profile(f"{phase}.profile", lambda: step(params, state, batch), 1)
    del state, params, model, step, batch
    torch.cuda.empty_cache()
    return launches


def encdec_f32_check(phase):
    """Whisper-medium in float32 cut to 2 encoder and 2 decoder layers at
    S=4096 with 1,500 frames: ``train_f32_check``, the attention on the
    FMA route."""
    from repro_torch.data.pipeline import synthetic_batch
    cfg = published_config("whisper_medium", n_layers=ENCDEC_F32_LAYERS,
                           n_encoder_layers=ENCDEC_F32_LAYERS,
                           dtype="float32")
    batch = {k: torch.from_numpy(v).cuda() for k, v in synthetic_batch(
        SEED, 1, 0, 1, 1, TRAIN_SEQ, cfg.vocab).items()}
    batch.update(family_input(cfg, np.random.default_rng(SEED + 1)))
    train_f32_check(phase, cfg, batch, FAMILY_PHASE_KERNELS,
                    FAMILY_PHASE_KERNELS)


def dense_train_cell(cell):
    """(name, arch, shape, overrides) of a ``DenseCell``'s train cell as
    ``launch_cells`` names it."""
    return (f"{cell.short}_train", cell.arch, train_shape(),
            {"dtype": "bfloat16", **cell.overrides(cell.train_layers)})


def dense_phases(smi):
    """Each of ``DENSE_CELLS``: ``serve_dense.<arch>`` (serve and prefill,
    ``serve_family_phase``) and ``train_dense.<arch>``
    (``train_family_phase``).  A cell with ``train_if_fits`` first runs its
    dry run (``dryrun.run_cell`` on the ``card`` mesh at microbatches 1,
    ``dry_run``): predicted not to fit, the train phase's line says so
    and the step is not run.  Returns {phase: launches}."""
    from repro_torch.launch.dryrun import HBM_BUDGET
    paths = {}
    for cell in DENSE_CELLS:
        phase = f"serve_dense.{cell.arch}"
        paths[phase] = serve_family_phase(cell.arch, phase, smi, cell=cell)
        phase = f"train_dense.{cell.arch}"
        if cell.train_if_fits:
            t0 = time.perf_counter()
            name = dense_train_cell(cell)[0]
            rec, dry_s = dry_run(name)
            if not rec["fits_hbm"]:
                emit(phase, smi=smi, run=False, layers=cell.train_layers,
                     reason="the dry run predicts that the step does not "
                            "fit the card", cell=name,
                     hbm_budget=HBM_BUDGET, **{k: rec[k] for k in (
                         "param_bytes", "opt_state_bytes",
                         "peak_memory_est", "fits_hbm")},
                     dry_run_seconds=dry_s, seconds=time.perf_counter() - t0)
                continue
        paths[phase] = train_family_phase(cell.arch, phase, smi, cell=cell)
    return paths


# ----------------------------------------------------------------------
# the launch tools: dry runs on the meta device against what the card
# measured, the fixed-wave ServeLoop, routing by address on the kernels
# ----------------------------------------------------------------------
POD_CELLS = ("mixtral_8x7b", "tinyllama_1_1b")   # train_4k on the pod mesh
# the dry runs are host work on the meta device that no card phase waits
# on: ``start_dry_runs`` runs them in processes of their own while the
# card phases run, each process taking one list (the pod cells first: the
# longest); ``dry_run`` reads their records
DRY_RUN_LISTS = (
    ("pod:mixtral_8x7b", "mixtral_train", "mamba_train", "llava_prefill",
     "whisper_prefill"),
    ("pod:tinyllama_1_1b", "mixtral_32_train", "llava_60_train",
     "command_r_prefill"),
    ("command_r_train", "qwen_train", "granite_train", "mixtral22_train"),
)
# cell -> (record, seconds): the dry runs done, here or in the processes
DRY_RUNS = {}
DRY_PROCS = []
_DRY_CHILD = """
import json, sys, time
from pathlib import Path
sys.path[:0] = [sys.argv[1], str(Path(sys.argv[1], "src"))]
import chip_smoke
from repro_torch.launch.dryrun import run_cell
cells = chip_smoke.launch_cells()
for name in sys.argv[2:]:
    t0 = time.perf_counter()
    if name.startswith("pod:"):
        rec = run_cell(name[4:], "train_4k", "pod",
                       out_dir=Path(sys.argv[1], "build", "dryrun"))
    else:
        arch, shape, overrides, _ = cells[name]
        rec = run_cell(arch, shape, "card", overrides=overrides,
                       microbatches=1,
                       out_dir=Path(sys.argv[1], "build", "dryrun"))
    print(json.dumps({"cell": name, "seconds": time.perf_counter() - t0,
                      "record": rec}), flush=True)
"""


def start_dry_runs() -> None:
    """Start one process a list of ``DRY_RUN_LISTS`` (one thread each,
    ``OMP_NUM_THREADS=1``); ``stop_dry_runs`` ends any still running."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for cells in DRY_RUN_LISTS:
        DRY_PROCS.append(subprocess.Popen(
            [sys.executable, "-c", _DRY_CHILD, HERE, *cells], cwd=HERE,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))


def stop_dry_runs() -> None:
    for proc in DRY_PROCS:
        if proc.poll() is None:
            proc.kill()
        proc.wait()


def dry_run(name):
    """(record, seconds) of launch cell ``name`` (``"pod:<arch>"``: that
    arch's ``train_4k`` on the pod mesh): from the processes of
    ``start_dry_runs``, waiting for them; else run here."""
    import pathlib
    from repro_torch.launch.dryrun import run_cell
    while name not in DRY_RUNS and DRY_PROCS:
        proc = DRY_PROCS.pop(0)
        out, _ = proc.communicate(timeout=TP_TIMEOUT)
        if proc.returncode:
            raise AssertionError(f"a dry-run process failed:\n{out[-3000:]}")
        for line in out.splitlines():
            if line.startswith('{"cell"'):
                got = json.loads(line)
                DRY_RUNS[got["cell"]] = (got["record"], got["seconds"])
    if name not in DRY_RUNS:
        t0 = time.perf_counter()
        out_dir = pathlib.Path(HERE, "build", "dryrun")
        if name.startswith("pod:"):
            rec = run_cell(name[4:], "train_4k", "pod", out_dir=out_dir)
        else:
            arch, shape, overrides, _ = launch_cells()[name]
            rec = run_cell(arch, shape, "card", out_dir=out_dir,
                           overrides=overrides, microbatches=1)
        DRY_RUNS[name] = (rec, time.perf_counter() - t0)
    return DRY_RUNS[name]
PREFILL_PEAK_BAND = (0.8, 1.25)   # measured / predicted peak, prefill cells
LAUNCH_KERNELS = SERVE_KERNELS + ("flash_fwd", "flash_bwd")


def launch_cells():
    """The dry-run cells: name -> (arch, shape, config overrides, the phase
    that ran the cell on the card, or None where the card cannot hold the
    cell and the dry run must say so).  Each is the config and shape its
    phase ran: the served Mixtral cut to 2 layers (remat "nothing", the MoE
    on the crossbar's kernel backend), the whole Mamba-2 780M (remat
    "dots"), LLaVA-NeXT-34B at all 60 layers and the whole Whisper-medium
    (bf16); and Mixtral-8x7B at its 32 layers and LLaVA-NeXT-34B at its 60
    trained at ``train_shape()``, the two that section 4 of PERF.md says
    exceed 80 GB; and the ``DENSE_CELLS``: each train cell (Command R+'s
    only where the dry run predicted a fit; else it must be predicted not
    to fit) and Command R+'s 8-layer prefill at S=4096."""
    from repro_torch.models.config import ShapeConfig
    served = serving_config()
    mixtral = {"n_layers": served.n_layers, "dtype": served.dtype,
               "remat": served.remat, "moe": served.moe}
    prefill = ShapeConfig("prefill_4k_b1", ENCDEC_SEQ, 1, "prefill")
    bf16 = {"dtype": "bfloat16"}
    cells = {
        "mixtral_train": ("mixtral_8x7b", train_shape(), mixtral, "train"),
        "mamba_train": ("mamba2_780m", train_shape(),
                        {**bf16, "n_layers": TRAIN_LAYERS["mamba2_780m"]},
                        "train_ssm"),
        "llava_prefill": ("llava_next_34b", prefill, bf16, "serve_vlm"),
        "whisper_prefill": ("whisper_medium", prefill, bf16,
                            "serve_encdec"),
        "mixtral_32_train": ("mixtral_8x7b", train_shape(),
                             {**mixtral, "n_layers": 32}, None),
        "llava_60_train": ("llava_next_34b", train_shape(), bf16, None),
    }
    for cell in DENSE_CELLS:
        name, arch, shape, overrides = dense_train_cell(cell)
        phase = f"train_dense.{arch}"
        cells[name] = (arch, shape, overrides,
                       phase if phase in MEASURED else None)
        if cell.short == "command_r":
            cells["command_r_prefill"] = (
                arch, prefill, {**bf16, **cell.overrides(cell.serve_layers)},
                f"serve_dense.{arch}")
    return cells


def launch_dry_runs():
    """(a): each cell through ``dryrun.run_cell`` on the ``card`` mesh at
    microbatches 1, with no card (the meta device), held against what its
    phase measured on the card in this run.  Parameter and optimizer bytes
    must equal the bytes the phase allocated, as integers; the cells the
    card ran must be predicted to fit and those it did not run (Mixtral-8x7B
    at 32 layers and LLaVA-NeXT-34B at 60 trained; Command R+'s train cell
    where its dry run said so) not to;
    the prefill cells' measured peak over the predicted must lie in
    ``PREFILL_PEAK_BAND`` (the records come from ``dry_run``; the train
    cells' ratio is printed only: the
    plain path on meta keeps chunked-attention and SSD intermediates that
    the kernels do not)."""
    from repro_torch.launch.dryrun import HBM_BUDGET
    table, failed = {}, []
    for name, (arch, shape, overrides, phase) in launch_cells().items():
        t0 = time.perf_counter()
        rec, dry_s = dry_run(name)
        emit("launch.dryrun", cell=name, seconds=dry_s,
             waited_seconds=time.perf_counter() - t0, record=rec)
        row = {k: rec[k] for k in (
            "param_bytes", "opt_state_bytes", "peak_memory_est", "fits_hbm",
            "flops_per_device", "roofline_fraction", "holdout_rel_err")}
        row["kind"] = shape.kind
        if phase is None:
            if rec["fits_hbm"]:
                failed.append(f"{name} predicted to fit")
        else:
            got = MEASURED[phase]
            ratio = got["max_memory_allocated"] / rec["peak_memory_est"]
            row.update(phase=phase, measured_param_bytes=got["param_bytes"],
                       measured_opt_state_bytes=got["opt_state_bytes"],
                       max_memory_allocated=got["max_memory_allocated"],
                       peak_ratio=ratio)
            if (rec["param_bytes"], rec["opt_state_bytes"]) != (
                    got["param_bytes"], got["opt_state_bytes"]):
                failed.append(f"{name}: state bytes")
            if not rec["fits_hbm"]:
                failed.append(f"{name} predicted not to fit")
            lo, hi = PREFILL_PEAK_BAND
            if shape.kind == "prefill" and not lo <= ratio <= hi:
                failed.append(f"{name}: peak ratio {ratio}")
        table[name] = row
    emit("launch.cells", hbm_budget=HBM_BUDGET, band=PREFILL_PEAK_BAND,
         cells=table, failed=failed)
    if failed:
        raise AssertionError(f"launch dry runs: {failed}")
    return table


def launch_pod_dry_runs():
    """(e): ``train_4k`` of Mixtral-8x7B (32 layers) and TinyLlama-1.1B on
    the ``pod`` mesh (16 x 16), one device's program on the meta device
    (host work only): FLOPs, bytes and collectives a device, peak and
    ``fits_hbm``, each with its seconds (``dry_run``)."""
    table = {}
    for arch in POD_CELLS:
        rec, dry_s = dry_run(f"pod:{arch}")
        keys = ("chips", "microbatches", "flops_per_device",
                "bytes_per_device", "collective_bytes_per_device",
                "collectives", "peak_memory_est", "fits_hbm", "bottleneck",
                "roofline_fraction", "holdout_rel_err", "param_bytes",
                "opt_state_bytes")
        table[arch] = {"seconds": dry_s, **{k: rec[k] for k in keys}}
        emit("launch.pod", cell=arch, **table[arch])
    bad = [a for a, r in table.items() if not (
        r["flops_per_device"] > 0 and r["collectives"]
        and r["collectives"]["all-reduce"]["moved"] > 0)]
    if bad:
        raise AssertionError(f"pod dry runs without FLOPs or collectives: "
                             f"{bad}")
    return table


def launch_serve_loop(engine, prompts):
    """(c): the deprecated fixed-wave ``ServeLoop`` on the served model's
    parameters, MoE on the crossbar kernels, against the same loop on the
    plain path on the card: equal tokens, the crossbar kernels launched."""
    import warnings
    from repro_torch.runtime.serve import Request, ServeLoop
    cfg = engine.model.cfg
    reqs = [Request(app_id=i, prompt=p, max_new=MAX_NEW)
            for i, p in enumerate(prompts)]
    out = {}
    for name, c in (("kernel", cfg),
                    ("plain", dataclasses.replace(cfg, kernel_mode="torch"))):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always", DeprecationWarning)
            loop = ServeLoop(c, batch=N_SLOTS, max_len=PROMPT_LEN + MAX_NEW,
                             params=engine.params)
        before = _counts()
        comps = loop.serve(reqs)
        torch.cuda.synchronize()
        after = _counts()
        out[name] = {"tokens": [c.tokens for c in comps],
                     "launches": {k: after[k] - before[k]
                                  for k in SERVE_KERNELS},
                     "decode_s": comps[0].decode_s,
                     "deprecated": any(issubclass(w.category,
                                                  DeprecationWarning)
                                       for w in caught)}
    same = out["kernel"]["tokens"] == out["plain"]["tokens"]
    emit("launch.serve_loop", model=cfg.name, layers=cfg.n_layers,
         requests=len(reqs), prompt_len=PROMPT_LEN, max_new=MAX_NEW, **out,
         same_tokens=same)
    if not (same and all(out["kernel"]["launches"][k] > 0
                         for k in SERVE_KERNELS)
            and not any(out["plain"]["launches"].values())
            and out["kernel"]["deprecated"]
            and all(len(t) == MAX_NEW for t in out["kernel"]["tokens"])):
        raise AssertionError("ServeLoop on the kernels disagrees with the "
                             "plain path or launched no crossbar kernel")


def launch_routing(engine):
    """(d): the op shapes of one train step (forward and backward) of the
    served model on the kernel path (``cuda_kernel``), recorded with
    ``lower_step``'s ``OpRecorder``: no dense [g*k, G*E*C] selection
    tensor (``dense_routing_bytes`` 0), the crossbar and flash kernels
    launched.  The control: the ``dense`` impl's MoE layer at
    ``moe_impls``'s shape (T=4096, groups of 1024) must show one."""
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.launch.roofline import dense_routing_bytes
    from repro_torch.launch.steps import _value_and_grad, record_step
    from repro_torch.models.common import init_params, tree_leaves
    from repro_torch.models.moe import expert_capacity, moe_apply, moe_defs
    model, cfg = engine.model, engine.model.cfg
    batch = {k: torch.from_numpy(v).cuda() for k, v in synthetic_batch(
        SEED, 0, 0, 1, 1, TRAIN_SEQ, cfg.vocab).items()}
    g = min(1024, TRAIN_SEQ)
    G, cap = TRAIN_SEQ // g, expert_capacity(g, cfg.moe)
    packets, pxc = g * cfg.moe.top_k, G * cfg.moe.n_experts * cap
    before = _counts()
    step = record_step(lambda p, b: _value_and_grad(model, p, b),
                       (engine.params, batch))
    torch.cuda.synchronize()
    after = _counts()
    for p in tree_leaves(engine.params):
        p.requires_grad_(False)
    launches = {k: after[k] - before[k] for k in LAUNCH_KERNELS}
    kernel_bytes = dense_routing_bytes(step.as_text(), packets, pxc)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 8)
    params = init_params(moe_defs(cfg.d_model, cfg.d_ff, cfg.moe,
                                  cfg.mlp_act), gen, torch.bfloat16, "cuda")
    x = torch.randn((1, TRAIN_SEQ, cfg.d_model), generator=gen,
                    device="cuda").to(torch.bfloat16)

    def dense_layer(p, x):
        leaves = [x.requires_grad_()] + [t.requires_grad_()
                                         for t in tree_leaves(p)]
        y, s = moe_apply(p, x, cfg.moe, cfg.mlp_act, group_size=g,
                         dispatch_impl="dense")
        loss = y.float().square().mean() + s["aux_loss"]
        return torch.autograd.grad(loss, leaves)

    control = record_step(dense_layer, (params, x))
    dense_bytes = dense_routing_bytes(control.as_text(), packets, pxc)
    emit("launch.routing", packets_a_group=packets, groups=G, capacity=cap,
         ports_x_capacity=pxc, kernel_step_ops=len(
             step.as_text().splitlines()), kernel_dense_routing_bytes=
         kernel_bytes, kernel_launches=launches,
         control="dense impl, one MoE layer, T=4096, groups of 1024",
         control_ops=len(control.as_text().splitlines()),
         control_dense_routing_bytes=dense_bytes)
    del params, x, step, control
    if kernel_bytes != 0 or dense_bytes <= 0:
        raise AssertionError(f"routing by address: kernel path "
                             f"{kernel_bytes} bytes, dense control "
                             f"{dense_bytes}")
    if any(n <= 0 for n in launches.values()):
        raise AssertionError(f"the recorded step did not run on the "
                             f"kernels: {launches}")


def launch_phase(smi):
    """The launch tools (``repro_torch.launch``): (a) the dry runs (done
    beside the card phases, ``start_dry_runs``: the line's dry-run seconds
    are the waits for them), (c)
    ``ServeLoop`` and (d) routing by address on a rebuilt served Mixtral
    ((b), ``build_step``, is the train phase's step).  Launches are counted
    over exactly (c) and (d).  Returns them."""
    from repro_torch.shell.server import ModelEngine
    t0 = time.perf_counter()
    cells = launch_dry_runs()
    t1 = time.perf_counter()
    pod = launch_pod_dry_runs()
    t_pod = time.perf_counter() - t1
    t1 = time.perf_counter()
    cfg = serving_config()
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab, PROMPT_LEN).astype(np.int32)
               for _ in range(4)]
    engine = ModelEngine(cfg, max_len=PROMPT_LEN + MAX_NEW, seed=SEED)
    torch.cuda.synchronize()
    _reset_counts()
    launch_serve_loop(engine, prompts)
    launch_routing(engine)
    launches = _counts()
    emit("launch", smi=smi, cells=len(cells),
         dry_run_seconds=t1 - t0 - t_pod, pod_dry_run_seconds=t_pod,
         pod_cells=len(pod), kernels=launches,
         seconds=time.perf_counter() - t0)
    del engine
    torch.cuda.empty_cache()
    return launches


# ----------------------------------------------------------------------
# the paper's use case: multiplier -> Hamming(31,26) encoder -> decoder
# ----------------------------------------------------------------------
BULK_WORDS = 1 << 28           # 1 GiB of words: a storage tenant's bulk ECC pass
MUL_CONSTANTS = (3, 7, 2654435761, 2**32 - 1, -1, -3)
MUL_ROUNDS = 10
PLAN_SHAPES = ((512, 4, 64, 128), (300, 8, 32, 64), (1024, 16, 128, 256),
               (64, 4, 8, 128))        # (T, S, C, D): tests/test_kernels.py
PLAN_TIMED = (1 << 20, 16, 1 << 16)    # (T, S, C) of the timed plan
USECASE_KERNELS = ("mul_const", "hamming_encode", "hamming_decode")


def paper_model_report():
    """The paper's experiments on the port's copy of the hardware model,
    each number beside the paper's, and the data-path cross-check on the
    Hamming kernels: ``repro_torch.examples.paper_usecase``, which prints
    them as ``examples/paper_usecase.py`` does.  Milliseconds here are the
    model's (the FPGA at 250 MHz and the server, calibrated to the paper),
    not times of the card."""
    from repro_torch.examples import paper_usecase
    rec = paper_usecase.run()
    fig5, cycles = rec["fig5"], rec["cycles"]
    grants, completions = cycles["sim_grants"], cycles["sim_completions"]
    emit("paper_model", model_ms={"fig5": fig5,
                                  "paper_case1": rec["paper_case1"],
                                  "paper_case3": rec["paper_case3"]},
         bandwidth=rec["bandwidth"],
         calibration_residuals=rec["calibration_residuals"],
         cycles=cycles, fig6=rec["fig6"], table2=rec["table2"],
         data_path_identical=rec["identical"])
    if (grants[0] != 4 or grants[-1] != 28 or completions[0] != 13
            or completions[-1] != 37
            or abs(fig5[1] - rec["paper_case1"]) > 1e-6
            or abs(fig5[3] - rec["paper_case3"]) > 1e-6):
        raise AssertionError("the hardware model no longer reproduces the "
                             "paper's calibrated numbers")
    if not rec["identical"]:
        raise AssertionError("the Hamming kernels' data path disagrees with "
                             "the cycle simulation's output")
    return rec["use_case"]


def usecase_path(uc):
    """The use case through the port's entry points: for k = 1, 2, 3 a
    ``Shell`` with k free regions admits one tenant whose footprints come
    from ``paper_chain``, and ``ModuleChain.apply`` runs the 16 KB on the
    placement (placed modules on the card's kernels, ``ON_SERVER`` ones on
    the CPU); then one tenant grows from 1 region to 3 without a rebuild.
    Every output must equal ``run_case(k).output``.  Returns the launches
    of exactly this path."""
    from repro_torch.core.elastic import ON_SERVER, Region
    from repro_torch.core.module import ModuleFootprint
    from repro_torch.kernels import build
    from repro_torch.kernels.hamming import kernel as HK
    from repro_torch.kernels.hamming.ops import paper_chain
    from repro_torch.shell import Shell
    t0 = time.perf_counter()
    data = np.random.default_rng(0).integers(0, 1 << 26, size=uc.n_words,
                                             dtype=np.uint32)
    x = torch.from_numpy(data.view(np.int32)).cuda().view(torch.uint32)
    chain = paper_chain(uc.constant)
    params = chain.init(torch.Generator().manual_seed(SEED))
    regions = lambda n: [Region(rid=i, n_chips=1, hbm_bytes=80 * GB)  # noqa: E731
                         for i in range(n)]
    names = [m.name for m in chain.modules]

    def run(placement, want):
        before = HK.launch_counts()
        out = chain.apply(params, x, placement)
        torch.cuda.synchronize()
        got = out.view(torch.int32).cpu().numpy().view(np.uint32)
        after = HK.launch_counts()
        on_card = {n: after[k] - before[k]
                   for n, k in zip(names, USECASE_KERNELS)}
        expect = {n: int(p != ON_SERVER) for n, p in zip(names, placement)}
        return {"placement": list(placement), "on_card": on_card,
                "equal": bool(np.array_equal(got, want)),
                "as_placed": out.device.type == "cuda" and on_card == expect}

    _reset_counts()
    cases = {}
    for k in (1, 2, 3):
        shell = Shell(regions(k))
        placement = shell.submit("usecase", chain)
        cases[k] = run(placement, uc.run_case(k).output)
        cases[k]["as_paper"] = placement == list(range(k)) + [ON_SERVER] * (
            3 - k)
    shell = Shell(regions(3))
    fp = ModuleFootprint(0, 1.0, 4)
    shell.submit("other", [fp, fp])
    grow = []
    for step in (lambda: shell.submit("usecase", chain),
                 lambda: shell.shrink("usecase", 1),
                 lambda: shell.release("other"),
                 lambda: shell.grow("usecase")):
        step()
        grow.append(run(shell.placement_of("usecase"),
                        uc.run_case(3).output))
    launches = _counts()
    loads = build.load_count[HK.LIB_NAME]
    emit("paper_usecase.path", words=uc.n_words, cases=cases, grow=grow,
         epoch=shell.epoch, hamming_library_loads=loads,
         kernels={k: launches[k] for k in USECASE_KERNELS},
         seconds=time.perf_counter() - t0)
    ok = (all(c["equal"] and c["as_placed"] and c["as_paper"]
              for c in cases.values())
          and all(g["equal"] and g["as_placed"] for g in grow)
          and grow[0]["placement"][1:] == [ON_SERVER, ON_SERVER]
          and ON_SERVER not in grow[-1]["placement"] and loads == 1
          and all(launches[k] > 0 for k in USECASE_KERNELS))
    if not ok:
        raise AssertionError("the use case disagrees with run_case, ran "
                             "where its placement does not say, or rebuilt")
    return launches


def hamming_check(name, x, constants=(3,)):
    """Each Hamming kernel against its plain version on ``x`` (int32);
    returns the largest difference (0 when bit-equal)."""
    from repro_torch.fabric.interface import KernelMode
    from repro_torch.kernels.hamming import kernel as HK, ref as href
    cuda = KernelMode.CUDA
    pairs = {"hamming_encode": (HK.hamming_encode(x, mode=cuda),
                                href.encode_ref(x))}
    dk, ck = HK.hamming_decode(x, mode=cuda)
    dr, cr = href.decode_ref(x)
    pairs["hamming_decode"] = (torch.stack([dk, ck]), torch.stack([dr, cr]))
    for c in constants:
        pairs[f"mul_const({c})"] = (HK.mul_const(x, c, mode=cuda),
                                    href.multiply_ref(x, c))
    torch.cuda.synchronize()
    res = {k: torch.equal(a, b) for k, (a, b) in pairs.items()}
    errs = {k: max_abs_err(a, b) for k, (a, b) in pairs.items()}
    emit("paper_usecase.check", case=name, words=x.numel(), **res)
    del pairs
    if not all(res.values()):
        raise AssertionError(f"a Hamming kernel disagrees on {name}: {res}")
    return {"hamming_encode": errs["hamming_encode"],
            "hamming_decode": errs["hamming_decode"],
            "mul_const": max(v for k, v in errs.items()
                             if k.startswith("mul_const"))}


def error_words(gen, n_per=4096):
    """Codewords with bit p flipped in block p (p = 0..31, bit 31 outside
    the codeword), then codewords with two distinct bits flipped."""
    from repro_torch.kernels.hamming import ref as href
    data = torch.randint(0, 1 << 26, (32 * n_per,), generator=gen,
                         device="cuda", dtype=torch.int32)
    code = href.encode_ref(data)
    pos = torch.arange(32, device="cuda").repeat_interleave(n_per)
    flip = (1 << pos) - ((pos == 31).long() << 32)         # bit 31 as int32
    single = code ^ flip.to(torch.int32)
    p1 = torch.randint(0, 31, code.shape, generator=gen, device="cuda")
    p2 = (p1 + torch.randint(1, 31, code.shape, generator=gen,
                             device="cuda")) % 31
    double = code ^ ((1 << p1) | (1 << p2)).to(torch.int32)
    return data, single, double, pos


def hamming_kernels():
    """The three kernels against their plain versions at the 16 KB of the
    use case, at 2^28 words (1 GiB) and 2^28 - 3, at every single-bit error
    position and at double-bit errors, and the multiplier at several
    constants; timings at 2^28 words."""
    from repro_torch.fabric.interface import KernelMode
    from repro_torch.kernels.hamming import kernel as HK, ref as href
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 5)
    words = lambda n: torch.randint(  # noqa: E731
        -(1 << 31), 1 << 31, (n,), generator=gen, device="cuda",
        dtype=torch.int64).to(torch.int32)
    errs = [hamming_check("16KB", words(4096), MUL_CONSTANTS)]
    data, single, double, pos = error_words(gen)
    errs.append(hamming_check("single_bit_errors", single))
    dk, ck = HK.hamming_decode(single, mode=KernelMode.CUDA)
    corrected = bool(torch.equal(dk, data)
                     and torch.equal(ck, (pos < 31).to(torch.int32)))
    errs.append(hamming_check("double_bit_errors", double))
    emit("paper_usecase.errors", every_position_corrected=corrected)
    if not corrected:
        raise AssertionError("a single-bit error was not corrected")
    errs.append(hamming_check("ragged_2^28-3", words(BULK_WORDS - 3)))
    x = words(BULK_WORDS)
    errs.append(hamming_check("bulk_2^28", x, MUL_CONSTANTS))
    cuda = KernelMode.CUDA
    n = x.numel()
    c = MUL_CONSTANTS[2]
    c32 = (c & 0xFFFFFFFF) - (1 << 32) * bool(c & (1 << 31))   # as int32
    mul = lambda: HK.mul_const(x, c, mode=cuda)  # noqa: E731
    library_mul = lambda: torch.mul(x, c32)  # noqa: E731
    out = {}
    for name, kernel, plain, n_bytes, library in (
            ("hamming_encode", lambda: HK.hamming_encode(x, mode=cuda),
             lambda: href.encode_ref(x), 8 * n, None),
            ("hamming_decode", lambda: HK.hamming_decode(x, mode=cuda),
             lambda: href.decode_ref(x), 12 * n, None),
            ("mul_const", mul, lambda: href.multiply_ref(x, c), 8 * n,
             library_mul)):
        b, by = bound(n_bytes, 0)
        out[name] = dict(
            ms=time_ms(kernel, reps=20), plain_ms=time_ms(plain, reps=3,
                                                          warmup=1),
            library_ms=None if library is None else time_ms(library, reps=20),
            bound_ms=b, bound_by=by, bytes=n_bytes)
    # mul_const against torch.mul in alternating rounds, each the median
    # of 20 calls: the two are within 1% of each other, less than one
    # timing moves
    rounds = []
    for r in range(MUL_ROUNDS):
        pair = (("mul_const", mul), ("torch.mul", library_mul))
        rounds.append({k: time_ms(fn, reps=20)
                       for k, fn in (pair if r % 2 == 0 else pair[::-1])})
    out["mul_const"]["mul_rounds"] = {
        "rounds": rounds,
        **{f"{k}_quartiles_ms": statistics.quantiles(
            [r[k] for r in rounds], n=4) for k in ("mul_const", "torch.mul")},
        **{f"{k}_median_ms": statistics.median(r[k] for r in rounds)
           for k in ("mul_const", "torch.mul")},
        "mul_const_won": sum(r["mul_const"] < r["torch.mul"] for r in rounds),
        "torch.mul_won": sum(r["torch.mul"] < r["mul_const"] for r in rounds)}
    emit("paper_usecase.time", words=n, constant=c, **out)
    del x
    torch.cuda.empty_cache()
    err = {k: max(e[k] for e in errs) for k in errs[0]}
    return err, out


def plan_inputs(T, S, C, gen, out_of_range=False):
    """One source's packets and register rows: isolation holes (at least
    one, and at least one open port), quota 0 = unlimited on every third
    port and C // 2 elsewhere, capacity C; with ``out_of_range``, 15% of the
    packets carry dst = -1, S or S + 3."""
    dst = torch.randint(0, S, (T,), generator=gen, device="cuda",
                        dtype=torch.int32)
    if out_of_range:
        bad = torch.rand((T,), generator=gen, device="cuda") < 0.15
        pick = torch.tensor([-1, S, S + 3], dtype=torch.int32, device="cuda")
        dst = torch.where(bad, pick[torch.randint(0, 3, (T,), generator=gen,
                                                  device="cuda")], dst)
    allowed = (torch.rand((S,), generator=gen, device="cuda") > 0.25).to(
        torch.int32)
    allowed[0], allowed[1] = 0, 1
    quota = torch.where(torch.arange(S, device="cuda") % 3 == 0, 0,
                        C // 2).to(torch.int32)
    cap = torch.full((S,), C, dtype=torch.int32, device="cuda")
    return dst, allowed, quota, cap


def plan_path():
    """The single-source plan kernel through the deprecated shims, one
    round each: ``crossbar_plan`` -> ``crossbar_dispatch`` ->
    ``crossbar_combine`` at the four shapes of ``tests/test_kernels.py``
    (and out-of-range ``dst`` at the first), the zero-packet round, and the
    timed shape.  Launches are counted over exactly these rounds; then each
    round's plan is held bit-equal to ``plan_ref`` and its slabs and
    combine to their plain versions, and the plan kernel is timed."""
    import warnings
    from repro_torch.fabric.interface import KernelMode
    from repro_torch.kernels import (crossbar_combine, crossbar_dispatch,
                                     crossbar_plan)
    from repro_torch.kernels.crossbar_dispatch import kernel as K, ref
    from repro_torch.kernels.timing import device_profile, host_us
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 6)
    T, S, C = PLAN_TIMED
    rounds = [("zero_packets", plan_inputs(0, 4, 8, gen), 8, 8)]
    for t, s, c, d in PLAN_SHAPES:
        rounds.append((f"T={t} S={s} C={c}", plan_inputs(t, s, c, gen), c, d))
    rounds.append(("out_of_range_dst", plan_inputs(512, 4, 64, gen, True),
                   64, 128))
    rounds.append((f"timed T={T} S={S} C={C}", plan_inputs(T, S, C, gen), C,
                   8))
    xs = [(torch.randn((dst.shape[0], d), generator=gen, device="cuda"),
           torch.rand((dst.shape[0],), generator=gen, device="cuda"))
          for _, (dst, *_), _, d in rounds]
    _reset_counts()
    outs = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        for (name, (dst, allowed, quota, cap), c, d), (x, w) in zip(rounds,
                                                                    xs):
            p = crossbar_plan(dst, allowed, quota, cap)
            slabs = crossbar_dispatch(x, dst, p[0], p[1],
                                      n_ports=allowed.shape[0], capacity=c)
            outs.append((p, slabs, crossbar_combine(slabs, dst, p[0], p[1],
                                                    w)))
    torch.cuda.synchronize()
    launches = _counts()
    checks = {}
    err = 0.0
    for (name, (dst, allowed, quota, cap), c, d), (x, w), (p, slabs, back) in \
            zip(rounds, xs, outs):
        pr = ref.plan_ref(dst, allowed, quota, cap)
        sr = ref.scatter_ref(x, dst, pr[0], pr[1], allowed.shape[0], c)
        cr = ref.combine_ref(sr, dst, pr[0], pr[1], w)
        checks[name] = {
            "plan": all(torch.equal(a, b) for a, b in zip(p, pr)),
            "dispatch": torch.equal(slabs, sr),
            "combine": torch.equal(back, cr),
            "granted": int(p[0].sum()),
            "invalid_dest": int((p[2] == 1).sum())}
        err = max([err] + [max_abs_err(a, b) for a, b in zip(p, pr)])
    b, by = bound(16 * T, 0)
    dst, allowed, quota, cap = rounds[-1][1]
    cuda = KernelMode.CUDA
    call = lambda: K.plan(dst, allowed, quota, cap, mode=cuda)
    # counted per event of the plan kernel: a card host lost 5 of the 20
    # calls' events in every window
    prof = device_profile(call, kernel="plan_kernel")
    t = dict(ms=time_ms(call),
             plain_ms=time_ms(lambda: ref.plan_ref(dst, allowed, quota, cap),
                              reps=5),
             library_ms=None, bound_ms=b, bound_by=by, bytes=16 * T,
             device_ms=prof["device_ms"], kernels_per_call=prof["kernels"],
             memsets_per_call=prof["memsets"], host_us=host_us(call))
    emit("paper_usecase.plan", checks=checks,
         kernels={k: launches[k] for k in ("plan", "scatter", "combine")},
         T=T, S=S, C=C, seconds=time.perf_counter() - t0, **t)
    if not all(v["plan"] and v["dispatch"] and v["combine"]
               for v in checks.values()):
        raise AssertionError(f"the plan shims disagree with plan_ref: "
                             f"{checks}")
    if checks["out_of_range_dst"]["invalid_dest"] == 0 or launches["plan"] \
            != len(rounds) - 1:
        raise AssertionError("the plan path did not run as laid out")
    if t["memsets_per_call"]:
        raise AssertionError(f"the plan at T={T} clears memory: {t}")
    return launches, err, t


def paper_usecase_phase(smi):
    t0 = time.perf_counter()
    uc = paper_model_report()
    usecase_launches = usecase_path(uc)
    ham_err, ham_t = hamming_kernels()
    plan_launches, plan_err, plan_t = plan_path()
    emit("paper_usecase", smi=smi, seconds=time.perf_counter() - t0)
    return usecase_launches, plan_launches, ham_err, ham_t, plan_err, plan_t


def main() -> int:
    global SEED
    if "--seed" in sys.argv[1:]:
        SEED = int(sys.argv[sys.argv.index("--seed") + 1])
    # 1. device -------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(HERE, "src"))
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    emit("device", name=kind, nvidia_smi=smi, count=torch.cuda.device_count(),
         seed=SEED, torch=torch.__version__, cuda=torch.version.cuda,
         numpy=np.__version__)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # 2. build --------------------------------------------------------
    from repro_torch.kernels import build
    from repro_torch.kernels.crossbar_dispatch import kernel as K
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.hamming import kernel as HK
    from repro_torch.kernels.rglru import kernel as RK
    from repro_torch.kernels.ssd import kernel as SK
    t0 = time.perf_counter()
    libs = {K.LIB_NAME: K.SOURCES, FK.LIB_NAME: FK.SOURCES,
            SK.LIB_NAME: SK.SOURCES, RK.LIB_NAME: RK.SOURCES,
            HK.LIB_NAME: HK.SOURCES}
    build.build_libraries(libs)
    for mod in (K, FK, SK, RK, HK):
        mod.library()
    emit("build", seconds=time.perf_counter() - t0,
         nvcc_seconds=dict(build.build_seconds),
         libraries=[build.library_path(n, srcs).name
                    for n, srcs in libs.items()])
    # the launch phase's dry runs, host work on the meta device, run
    # beside the card phases from here on
    start_dry_runs()
    atexit.register(stop_dry_runs)

    # 3. crossbar kernels ---------------------------------------------
    from repro_torch.models.moe import expert_capacity
    t0 = time.perf_counter()
    cfg = serving_config()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    bf16, f32 = torch.bfloat16, torch.float32
    d, E = cfg.d_model, cfg.moe.n_experts
    cap1, cap2 = expert_capacity(1, cfg.moe), expert_capacity(2, cfg.moe)
    big_c = expert_capacity(4096, cfg.moe)
    # the train step's groups: min(1024, B*S) tokens, top-2 (models/lm.py)
    train_g = min(1024, TRAIN_SEQ)
    served = [
        Case("moe_decode", 2, E, cap1, d, bf16, 1, gen, holes=False),
        Case("moe_prefill", 4, E, cap2, d, bf16, 1, gen, holes=False),
        Case("server_tick", N_SLOTS, 3, 8, 4, f32, 3, gen),
        Case("moe_train", train_g * cfg.moe.top_k, E,
             expert_capacity(train_g, cfg.moe), d, bf16, 1, gen, holes=False),
    ]
    large = [
        Case("large_bf16", 8192, E, big_c, d, bf16, E, gen),
        Case("large_f32", 8192, E, big_c, d, f32, E, gen),
        Case("ragged_bf16", 8189, E, big_c, d, bf16, E, gen),
        Case("plan_65536", 65536, 16, 4096, 8, f32, 16, gen),
    ]
    errs = {}
    for case in served + large:
        errs[case.name] = case.check()
    decode_t = served[0].timings()
    train_t = served[3].timings()
    train_shape = (f"T={served[3].T} S={served[3].S} C={served[3].C} "
                   f"D={served[3].D} bf16")
    large_t = large[0].timings()
    for case, t in (("moe_decode", decode_t), ("moe_train", train_t)):
        for name in ("scatter", "combine", "plan_multi", "plan_fabric",
                     "backend_plan"):
            if t[name]["kernels_per_call"] != 1 or t[name]["memsets_per_call"]:
                raise AssertionError(f"{name} at {case} is not one kernel "
                                     f"and no memset a call: {t[name]}")
    del served, large
    emit("kernels", seconds=time.perf_counter() - t0)

    # 3b. the fabric's sanitizer, and the MoE's dense and gather impls --
    fabric_debug_phase()
    moe_impls_phase()

    # 4. flash attention ----------------------------------------------
    t0 = time.perf_counter()
    flash_err, flash_t = flash_phase()
    torch.cuda.empty_cache()
    emit("flash", seconds=time.perf_counter() - t0)

    # 4b. every family's smoke config on the kernels -------------------
    smoke_launches = smoke_widths_phase()
    torch.cuda.empty_cache()

    # 5. serve, and the closed control loop over the served tenant ------
    engine, serve_launches = serve_phase(cfg, smi)
    mixtral_launches = manager_mixtral_phase(engine, smi)

    # 6. train --------------------------------------------------------
    train_launches, step_ms = train_phase(engine, smi)
    del engine
    torch.cuda.empty_cache()
    f32_check(cfg)

    # 6b. the training runtime: TrainLoop, checkpoints, remat, resume ----
    loop_launches = train_loop_phase(smi)

    # 7. the recurrent families' kernels --------------------------------
    t0 = time.perf_counter()
    ssd_err, ssd_t = ssd_phase()
    rglru_err, rglru_t = rglru_phase()
    d256_err, d256_t = flash_d256_phase()
    torch.cuda.empty_cache()
    emit("recurrent_kernels", seconds=time.perf_counter() - t0)

    # 7c. the recurrent families' backward kernels ----------------------
    bwd = recurrent_bwd_phase()

    # 8. serve and prefill the recurrent families ----------------------
    ssm_launches = serve_recurrent_phase("mamba2_780m", "serve_ssm", smi)
    hybrid_launches = serve_recurrent_phase("recurrentgemma_9b",
                                            "serve_hybrid", smi)

    # 8b. train the recurrent families ----------------------------------
    ssm_train_launches = recurrent_train_phase("mamba2_780m", "train_ssm",
                                               smi)
    hybrid_train_launches = recurrent_train_phase("recurrentgemma_9b",
                                                  "train_hybrid", smi)

    # 8c. the encoder-decoder and the vision-language model -------------
    encdec_launches = serve_family_phase("whisper_medium", "serve_encdec",
                                         smi)
    encdec_train_launches = train_family_phase("whisper_medium",
                                               "train_encdec", smi)
    encdec_f32_check("train_encdec")
    vlm_launches = serve_family_phase("llava_next_34b", "serve_vlm", smi)
    vlm_train_launches = train_family_phase(
        "llava_next_34b", "serve_vlm.train", smi, layers=VLM_TRAIN_LAYERS,
        lr=VLM_TRAIN_LR)

    # 8c2. the dense family's other published configs at their widths ----
    dense_launches = dense_phases(smi)

    # 8d. the launch tools: dry runs against this run, ServeLoop, routing --
    launch_launches = launch_phase(smi)

    # 9. the paper's use case and the single-source plan ---------------
    (usecase_launches, plan_launches, ham_err, ham_t, plan_err,
     plan_t) = paper_usecase_phase(smi)

    # 10. the seeded serve harness and the manager's scenarios ----------
    harness_launches = serve_harness_phase(smi)
    scenario_launches = manager_scenarios_phase(smi)

    # 12. mesh expert parallelism: the sharded MoE on 4 ranks, last, so
    # that no other phase's profiler windows follow its ranks ----------
    sharded_launches = sharded_phase(smi)

    # 13. tensor parallelism: DenseLM over a (2, 2) mesh of 4 ranks, and
    # the train step over NCCL at world size 1 ---------------------------
    tp_launches = tensor_parallel_phase(smi)

    # 14. tensor parallelism of the SSM, hybrid and encoder-decoder
    # families over the same mesh, and the four examples as modules -----
    tpf_launches = tensor_parallel_families_phase(smi)
    example_launches = examples_phase(smi)
    loads = dict(build.load_count)
    if any(n != 1 for n in loads.values()):
        raise AssertionError(f"a kernel library was loaded twice: {loads}")

    # 11. summary -----------------------------------------------------
    paths = {"serve": serve_launches, "train": train_launches,
             "train_loop": loop_launches,
             "serve_ssm": ssm_launches, "serve_hybrid": hybrid_launches,
             "train_ssm": ssm_train_launches,
             "train_hybrid": hybrid_train_launches,
             "serve_encdec": encdec_launches,
             "train_encdec": encdec_train_launches,
             "serve_vlm": vlm_launches,
             "serve_vlm.train": vlm_train_launches,
             **dense_launches,
             "launch": launch_launches,
             "paper_usecase": usecase_launches, "plan_shims": plan_launches,
             "smoke_widths": smoke_launches,
             "manager_mixtral": mixtral_launches,
             "serve_harness": harness_launches,
             "manager_scenarios": scenario_launches,
             "sharded": sharded_launches,
             "tensor_parallel": tp_launches,
             "tensor_parallel_families": tpf_launches,
             "examples": example_launches}

    def launch_keys(name):
        by_path = {p: c.get(name, 0) for p, c in paths.items()}
        return {"launches": sum(by_path.values()),
                "launches_by_path": by_path}

    replaces = {
        "plan_multi": "src/repro/kernels/crossbar_dispatch/kernel.py:196",
        "scatter": "src/repro/kernels/crossbar_dispatch/kernel.py:269",
        "combine": "src/repro/kernels/crossbar_dispatch/kernel.py:321",
        "flash_fwd": "src/repro/kernels/flash_attention/kernel.py:107",
        "flash_bwd": "src/repro/kernels/flash_attention/kernel.py:107",
        "flash_fwd_d256": "src/repro/kernels/flash_attention/kernel.py:107",
        "ssd": "src/repro/kernels/ssd/kernel.py:80",
        "rglru": "src/repro/kernels/rglru/kernel.py:63",
        # the TPU kernels have no backward: the line of the forward
        "ssd_bwd": "src/repro/kernels/ssd/kernel.py:80",
        "rglru_bwd": "src/repro/kernels/rglru/kernel.py:63",
        "flash_bwd_d256": "src/repro/kernels/flash_attention/kernel.py:107",
        "plan": "src/repro/kernels/crossbar_dispatch/kernel.py:90",
        "hamming_encode": "src/repro/kernels/hamming/kernel.py:109",
        "hamming_decode": "src/repro/kernels/hamming/kernel.py:114",
        "mul_const": "src/repro/kernels/hamming/kernel.py:119",
    }
    timing_keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    src = "src/repro_torch/kernels/crossbar_dispatch/csrc/crossbar_dispatch.cu"
    rows = []
    for name in ("plan_multi", "scatter", "combine"):
        t = decode_t[name]
        rows.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces[name], **launch_keys(name),
            "max_abs_err": max(e[name] for e in errs.values()),
            **t,
            "shape": "moe_decode T=2 S=8 C=8 D=4096 bf16",
            "train": {"shape": train_shape, **train_t[name]},
            "large": {"shape": "T=8192 S=8 C=1280 D=4096 bf16",
                      **large_t[name]},
        })
        if name == "plan_multi":
            # the fabric's plan entry, whose launches count as plan_multi's
            for entry in ("plan_fabric", "backend_plan"):
                rows[-1][entry] = {"decode": decode_t[entry],
                                   "train": train_t[entry],
                                   "large": large_t[entry]}
    src = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
    for name in ("flash_fwd", "flash_bwd"):
        t = flash_t[name]
        rows.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces[name], **launch_keys(name),
            "max_abs_err": flash_err[name],
            **{k: t[k] for k in timing_keys}, "fma_ms": t["fma_ms"],
            "launches_by_route": {r: paths["train"][f"{name}_{r}"]
                                  for r in ("tc", "fma")},
            "launches_by_route_by_path": {
                p: {r: c.get(f"{name}_{r}", 0) for r in ("tc", "fma")}
                for p, c in paths.items() if c.get(name, 0)},
            "shape": "B=1 S=4096 H=32 Kv=8 D=128 bf16 causal window=4096",
            # the encoder-decoder's, the vlm's and the dense cells' shapes
            "shapes": {case: {k: v for k, v in t_case.items()
                              if k not in ("flash_fwd", "flash_bwd")}
                       | {k: t_case[name][k] for k in timing_keys
                          + ("fma_ms", "library_factor", "bound_share",
                             "library")}
                       for case, t_case in flash_t["shapes"].items()},
        })
    rows.append({
        "name": "flash_fwd_d256", "route": "cuda", "source": src,
        "replaces": replaces["flash_fwd_d256"], **launch_keys("flash_fwd_d256"),
        "max_abs_err": d256_err, **{k: d256_t[k] for k in timing_keys},
        "fma_ms": d256_t["fma_ms"],
        "launches_by_route": {r: paths["serve_hybrid"][f"flash_fwd_d256_{r}"]
                              for r in ("tc", "fma")},
        "shape": "B=1 S=32768 H=16 Kv=1 D=256 bf16 causal window=2048",
    })
    d256_bwd_err, d256_bwd_t = bwd["flash_bwd_d256"]
    rows.append({
        "name": "flash_bwd_d256", "route": "cuda", "source": src,
        "replaces": replaces["flash_bwd_d256"],
        **launch_keys("flash_bwd_d256"), "max_abs_err": d256_bwd_err,
        **{k: d256_bwd_t[k] for k in timing_keys},
        "fma_ms": d256_bwd_t["fma_ms"],
        **{k: d256_bwd_t[k] for k in ("device_ms", "kernels_per_call",
                                      "passes")},
        "launches_by_route": {r: paths["train_hybrid"][f"flash_bwd_d256_{r}"]
                              for r in ("tc", "fma")},
        "shape": "B=1 S=4096 H=16 Kv=1 D=256 bf16 causal window=2048",
    })
    new_rows = (
        ("ssd", "src/repro_torch/kernels/ssd/csrc/ssd.cu", ssd_err, ssd_t,
         "B=1 S=32768 H=48 P=64 N=128 chunk=256 bf16"),
        ("ssd_bwd", "src/repro_torch/kernels/ssd/csrc/ssd.cu",
         *bwd["ssd_bwd"], "B=1 S=4096 H=48 P=64 N=128 chunk=256 bf16"),
        ("rglru_bwd", "src/repro_torch/kernels/rglru/csrc/rglru.cu",
         *bwd["rglru_bwd"], "B=1 S=4096 L=4096 u bf16, a float32"),
        ("rglru", "src/repro_torch/kernels/rglru/csrc/rglru.cu", rglru_err,
         rglru_t, "B=1 S=32768 L=4096 float32"),
        ("plan", "src/repro_torch/kernels/crossbar_dispatch/csrc/"
         "crossbar_dispatch.cu", plan_err, plan_t,
         f"T={PLAN_TIMED[0]} S={PLAN_TIMED[1]} C={PLAN_TIMED[2]} int32"),
    )
    ham_src = "src/repro_torch/kernels/hamming/csrc/hamming.cu"
    new_rows += tuple(
        (name, ham_src, ham_err[name], ham_t[name],
         f"{BULK_WORDS} words int32" + (
             f" constant={MUL_CONSTANTS[2]}" if name == "mul_const" else ""))
        for name in USECASE_KERNELS)
    for name, source, err, t, shape in new_rows:
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces[name], **launch_keys(name),
            "max_abs_err": err, **{k: t[k] for k in timing_keys},
            "shape": shape,
        })
        if name in ("ssd", "ssd_bwd", "rglru_bwd"):
            rows[-1].update({k: t[k] for k in (
                "device_ms", "kernels_per_call", "passes")})
        if name == "rglru":
            rows[-1].update({k: t[k] for k in (
                "entry_ms", "entry_bound_ms", "kernels_per_call")},
                entry_shape="B=1 S=32768 L=4096 u bf16, a float32, h bf16")
        if name == "mul_const":
            rows[-1]["mul_rounds"] = t["mul_rounds"]
        if name == "plan":
            rows[-1].update({k: t[k] for k in (
                "device_ms", "kernels_per_call", "memsets_per_call",
                "host_us")})
    if len(rows) != 15:
        raise AssertionError(f"{len(rows)} kernel rows, not 15")
    emit("done", seconds=time.perf_counter() - t_start,
         train_step_ms=step_ms)
    print(smi, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def profile(phase: str, fn, steps: int) -> None:
    """Device time by kernel and the device's idle share over ``steps``
    warm calls of ``fn`` (``torch.profiler``), and a Chrome trace in
    ``build/profile/``."""
    from torch.profiler import ProfilerActivity
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # kernel events only: an operator's row repeats its kernels' time
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda e: -e.self_device_time_total)
    device_us = sum(e.self_device_time_total for e in rows)
    out_dir = os.path.join(HERE, "build", "profile")
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, f"{phase}_trace.json"))
    emit(phase, steps=steps, wall_ms_per_step=wall / steps * 1e3,
         device_ms_per_step=device_us / steps / 1e3,
         device_idle_share=1 - device_us / 1e6 / wall,
         top=[{"name": e.key[:80], "calls": e.count,
               "device_ms_per_step": e.self_device_time_total / steps / 1e3}
              for e in rows[:15]],
         # the port's own kernels, wherever they rank
         port_kernels=[{"name": e.key[:120], "calls": e.count,
                        "device_ms_per_step":
                        e.self_device_time_total / steps / 1e3}
                       for e in rows if is_port_kernel(e.key)])


def is_port_kernel(name: str) -> bool:
    """Is profiler row ``name`` one of the kernels of
    ``src/repro_torch/kernels/*/csrc/*.cu`` (each kept in an anonymous
    namespace there)?"""
    if not hasattr(is_port_kernel, "names"):
        src = os.path.join(HERE, "src", "repro_torch", "kernels")
        found = set()
        for d in os.listdir(src):
            csrc = os.path.join(src, d, "csrc")
            for f in os.listdir(csrc) if os.path.isdir(csrc) else ():
                with open(os.path.join(csrc, f)) as fh:
                    found |= set(re.findall(
                        r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?"
                        r"(\w+)", fh.read()))
        is_port_kernel.names = found
    head = name.split("(anonymous namespace)::", 1)[-1].removeprefix("tc::")
    return "(anonymous namespace)::" in name and "at::native" not in name \
        and re.split(r"[<(]", head)[0] in is_port_kernel.names


if __name__ == "__main__":
    sys.exit(main())
