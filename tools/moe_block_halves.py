"""Why does a MoE block's prefill contribution read 1-7% kernel vs plain
path on the card, where every dense block reads under 1%?

    python3 tools/moe_block_halves.py

On the card, it runs ``chip_smoke.py``'s ``moe_block_halves`` (bf16,
random weights from seed 0, the MoE on the crossbar kernels) on
Mixtral-8x22B cut to 8 of 56 layers at S=8192, where its window of 4096
cuts keys, and at S=4096, where it cuts none, and on the served 2-layer
Mixtral-8x7B at S=4096.  For each block fed the plain path's hidden state
it reads the attention half (kernel vs plain), the MoE half fed the same
normed input, the share of tokens whose top-2 expert set differs between
the router on the two paths' own residuals, the whole block, and the plain
block against itself with its input moved by one bf16 ulp (the control).

It prints the card's name and power limit, then one JSON line a model and
length.
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def halves(name, cfg, seqs):
    from repro_torch.shell.server import ModelEngine
    engine = ModelEngine(cfg, max_len=cs.PROMPT_LEN + cs.MAX_NEW,
                         seed=cs.SEED)
    plain = cs._plain(cfg)
    rng = np.random.default_rng(cs.SEED)
    for S in seqs:
        t0 = time.perf_counter()
        tokens = rng.integers(0, cfg.vocab, (1, S)).astype(np.int32)
        blocks = cs.moe_block_halves(
            engine.model, plain, engine.params,
            {"tokens": torch.from_numpy(tokens).cuda()})
        cs.emit("moe_block_halves", model=name, layers=cfg.n_layers,
                seq=S, window=cfg.attn_window, blocks=blocks,
                seconds=time.perf_counter() - t0)
    del engine, plain
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("moe_block_halves: CUDA is not available", file=sys.stderr)
        return 1
    print(cs.nvidia_smi_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import build
    from repro_torch.kernels.crossbar_dispatch import kernel as K
    from repro_torch.kernels.flash_attention import kernel as FK
    build.build_libraries({K.LIB_NAME: K.SOURCES, FK.LIB_NAME: FK.SOURCES})
    cell, = (c for c in cs.DENSE_CELLS if c.arch == "mixtral_8x22b")
    halves("mixtral_8x22b", cell.config(cell.serve_layers),
           (cell.prefill_seq, cs.TRAIN_SEQ))
    halves("mixtral_8x7b", cs.serving_config(), (cs.TRAIN_SEQ,))
    return 0


if __name__ == "__main__":
    sys.exit(main())
