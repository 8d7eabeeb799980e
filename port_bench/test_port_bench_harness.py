"""The harness driven end to end on the CPU at smoke widths, skipping its
look for a card: a sound run of each driver comes out correct, and the
timed path broken underneath comes out not correct, once for each fault
its cell can have."""
from __future__ import annotations

import copy
import sys

import pytest
import torch

from port_bench import bench
from port_bench.run import run_cell

SRC = str(bench.ROOT / "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)


def smoke_config(dtype: str = "float32", capacity_factor: float = 1.25,
                 window=None) -> dict:
    cfg = copy.deepcopy(bench.config_spec("mixtral-8x7b"))
    cfg.update(name="mixtral-smoke", hidden_size=64, intermediate_size=128,
               num_attention_heads=4, num_key_value_heads=2,
               num_local_experts=4, num_hidden_layers=2, vocab_size=512,
               sliding_window=window)
    cfg["moe"]["capacity_factor"] = capacity_factor
    cfg["port"] = {"dtype": dtype, "remat": "nothing",
                   "dispatch": "cuda_kernel"}
    return cfg


def train_cell() -> dict:
    cell = copy.deepcopy(bench.cell_spec("mixtral-8x7b.train_4k"))
    cell["traffic"].update(batch=1, seq_len=128)
    cell["limits"] = {"grad_median": 1e-4, "change_gap": 1e-3,
                      "grad_rel_median": 1e-4}
    return cell


def prefill_cell() -> dict:
    cell = copy.deepcopy(bench.cell_spec("mixtral-8x22b.prefill_docs"))
    cell["traffic"].update(lengths=[32, 64, 96], counts=[2, 1, 1])
    cell["limits"] = {"logits_rel_l2_min": 1e-4}
    return cell


def _run(name, cell, cfg, seed=2 ** 31 + 11, seconds=0.01):
    return run_cell(name, seed, seconds, False, torch.device("cpu"),
                    cell=cell, config=cfg, t_start=0.0)


@pytest.mark.parametrize("window", [None, 32])
def test_train_sound_run_is_correct(window):
    b = _run("mixtral-8x7b.train_4k", train_cell(), smoke_config(window=window))
    assert b.correct, (b.checks, b.faults, b.work["readings"])
    assert b.attempted >= 1 and b.failed == 0
    assert b.e2e["train_tokens_per_s"] > 0


def test_train_state_left_unchanged_is_not_correct(monkeypatch):
    from repro_torch.optim.adamw import AdamW
    monkeypatch.setattr(AdamW, "apply_updates",
                        staticmethod(lambda params, updates: params))
    b = _run("mixtral-8x7b.train_4k", train_cell(), smoke_config())
    assert not b.correct
    assert b.checks["change_gap"][0] > 0.9


def test_train_half_the_tokens_left_out_is_not_correct(monkeypatch):
    from repro_torch.models import lm
    sound = lm.chunked_lm_loss

    def half(h, w_head, labels, true_vocab, chunk=512):
        n = h.shape[1] // 2
        return sound(h[:, n:], w_head, labels[:, n:], true_vocab, chunk)
    monkeypatch.setattr(lm, "chunked_lm_loss", half)
    b = _run("mixtral-8x7b.train_4k", train_cell(), smoke_config())
    assert not b.correct


@pytest.mark.parametrize("window", [None, 32])
def test_prefill_sound_run_is_correct(window):
    b = _run("mixtral-8x22b.prefill_docs", prefill_cell(),
             smoke_config(window=window))
    assert b.correct, (b.checks, b.faults, b.work["readings"])
    assert b.attempted == 4 and b.failed == 0
    assert b.e2e["prefill_p95_ms"] > 0
    assert sorted(b.checks) == [f"logits_rel_l2_min.{n}" for n in (32, 64, 96)]


def test_prefill_one_length_wrong_is_not_correct(monkeypatch):
    """Answers wrong at the longest length alone fail that length's
    check, however many shorter requests pass."""
    from repro_torch.models.lm import DenseLM
    sound = DenseLM.prefill

    def long_wrong(self, params, batch):
        out = sound(self, params, batch)
        return out * 2 if batch["tokens"].shape[1] == 96 else out
    monkeypatch.setattr(DenseLM, "prefill", long_wrong)
    cell = prefill_cell()
    cell["traffic"].update(counts=[3, 3, 1], checked_per_length=3)
    b = _run("mixtral-8x22b.prefill_docs", cell, smoke_config())
    assert not b.correct
    failed = [k for k, (v, lim) in b.checks.items() if v > lim]
    assert failed == ["logits_rel_l2_min.96"]


def test_prefill_answer_altered_is_not_correct(monkeypatch):
    from repro_torch.models.lm import DenseLM
    sound = DenseLM.prefill

    def altered(self, params, batch):
        # the answer of the prompt without its last token
        return sound(self, params, {"tokens": batch["tokens"][:, :-1]})
    monkeypatch.setattr(DenseLM, "prefill", altered)
    b = _run("mixtral-8x22b.prefill_docs", prefill_cell(), smoke_config())
    assert not b.correct


@pytest.mark.parametrize("name,cell,kind,number,limit", [
    ("mixtral-8x7b.train_4k", train_cell, "train", "grad_rel_median",
     "grad_rel_median"),
    ("mixtral-8x22b.prefill_docs", prefill_cell, "prefill", "least_min",
     "logits_rel_l2_min"),
])
def test_control_in_the_programs_place_is_not_correct(name, cell, kind,
                                                      number, limit):
    """The control (the reference in float8, ``calibrate.control``) read
    against the same float32 reference fails the number a sound run
    passes."""
    from port_bench import calibrate
    c = cell()
    b = _run(name, c, smoke_config())
    assert b.correct
    assert calibrate.control(b, kind)[number] > 10 * c["limits"][limit]
