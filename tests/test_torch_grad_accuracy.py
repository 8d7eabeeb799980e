"""The readings of ``repro_torch.launch.grad_accuracy`` (a leaf's relative
L2 distance from a float32 reference and the shares of its elements whose
signs agree), on small CPU tensors whose answers are known."""
import numpy as np
import pytest
import torch

from repro_torch.launch import grad_accuracy as GA


def test_leaf_reading_counts_signs_and_distance():
    ref = torch.tensor([4.0, -4.0, 1.0, -1.0, 0.5, -0.5, 2.0, -2.0])
    got = torch.tensor([4.0, -4.0, 1.0, 1.0, -0.5, -0.5, 2.0, -2.0])
    r = GA.leaf_reading(got, ref)
    # RMS 2.30: the two elements of magnitude 4 are the large ones
    assert r["n"] == 8 and r["n_large"] == 2
    assert r["sign_agree"] == 6 / 8
    assert r["sign_agree_large"] == 1.0
    want = float((got - ref).double().norm() / ref.double().norm())
    assert r["rel_l2"] == pytest.approx(want, rel=1e-12)   # summed in float64


@pytest.mark.parametrize("chunk", [3, 1 << 24])
def test_leaf_reading_does_not_depend_on_the_chunk(monkeypatch, chunk):
    rng = np.random.default_rng(0)
    ref = torch.from_numpy(rng.normal(size=1000).astype(np.float32))
    got = (ref + 0.1 * torch.from_numpy(
        rng.normal(size=1000).astype(np.float32))).bfloat16()
    monkeypatch.setattr(GA, "CHUNK", chunk)
    r = GA.leaf_reading(got, ref)
    g = got.float()
    assert r["rel_l2"] == pytest.approx(float((g - ref).norm() / ref.norm()),
                                        rel=1e-6)
    assert r["sign_agree"] == int((torch.sign(g) == torch.sign(ref)
                                   ).sum()) / 1000


def test_summary_weights_by_elements_and_names_the_worst():
    rows = [{"leaf": "a", "rel_l2": 0.1, "sign_agree": 1.0,
             "sign_agree_large": 1.0, "n": 30, "n_large": 10},
            {"leaf": "b", "rel_l2": 0.3, "sign_agree": 0.5,
             "sign_agree_large": 0.9, "n": 10, "n_large": 10},
            {"leaf": "c", "rel_l2": 0.2, "sign_agree": 0.9,
             "sign_agree_large": 1.0, "n": 10, "n_large": 0}]
    s = GA.summary(rows)
    assert s["sign_agree"] == pytest.approx((30 + 5 + 9) / 50)
    assert s["sign_agree_large"] == pytest.approx(19 / 20)
    assert s["worst_rel_l2"] == ["b", 0.3]
    assert s["least_sign_agree"] == ["b", 0.5]
    assert s["median_rel_l2"] == 0.2


def test_leaf_names_follow_tree_leaves():
    from repro_torch.models.common import leaf_names, tree_leaves
    tree = {"embed": torch.zeros(1), "layers": [{"w": torch.zeros(1),
                                                 "b": torch.zeros(1)}],
            "norm": torch.zeros(1)}
    names = leaf_names(tree)
    assert names == ["embed", "layers[0].w", "layers[0].b", "norm"]
    assert len(names) == len(tree_leaves(tree))
