"""The port's Hamming(31,26) encoder and decoder and constant multiplier
against the JAX package, on the CPU.

Seeded numpy words go through the JAX package's ops (the Pallas kernels in
interpret mode, as ``tests/test_kernels.py`` runs them), its numpy oracle
(``repro.kernels.hamming.ref``) and the port's ops, which take their plain
versions on CPU tensors.  Every check is bit-equal: the arithmetic is
integer.  The numpy oracle cannot take a negative constant, so those are
held against JAX only.  The JAX ops refuse an empty stream; the port takes
one, and its empty results are held against the numpy oracle.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.hamming import ops as jops
from repro.kernels.hamming import ref as jref
from repro_torch.fabric.interface import KernelMode
from repro_torch.kernels.hamming import kernel as K
from repro_torch.kernels.hamming import ops, ref

LENGTHS = [1, 100, 4096, 10000, 8192 * 2 + 5]
CONSTANTS = [3, 7, 2654435761, 2**32 - 1, 2**40 + 5, -1, -3, -(2**31)]


def _words(n, seed, bits=32):
    return np.random.default_rng(seed).integers(0, 1 << bits, size=n,
                                                dtype=np.uint64
                                                ).astype(np.uint32)


def _np(t: torch.Tensor) -> np.ndarray:
    assert t.dtype == torch.uint32
    return t.view(torch.int32).numpy().view(np.uint32)


def _single_bit_errors(code, rng):
    """Flip one random bit of the codeword in half of the words."""
    pos = rng.integers(0, 31, size=code.size).astype(np.uint32)
    flip = np.where(rng.random(code.size) < 0.5, np.uint32(1) << pos,
                    np.uint32(0)).astype(np.uint32)
    return code ^ flip, flip


@pytest.mark.parametrize("n", LENGTHS)
def test_encode_matches_jax_and_oracle(n):
    data = _words(n, n)                      # all 32 bits: encode masks to 26
    out = _np(ops.hamming_encode(torch.from_numpy(data)))
    np.testing.assert_array_equal(out, np.asarray(jops.hamming_encode(
        jnp.asarray(data))))
    np.testing.assert_array_equal(out, jref.encode_ref(data))


@pytest.mark.parametrize("n", LENGTHS)
def test_decode_matches_jax_and_oracle(n):
    rng = np.random.default_rng(n + 1)
    data = _words(n, n + 2, bits=26)
    corrupted, flip = _single_bit_errors(jref.encode_ref(data), rng)
    dec, corr = ops.hamming_decode(torch.from_numpy(corrupted))
    jdec, jcorr = jops.hamming_decode(jnp.asarray(corrupted))
    for a, b in ((dec, jdec), (corr, jcorr)):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    rdec, rcorr = jref.decode_ref(corrupted)
    np.testing.assert_array_equal(_np(dec), rdec)
    np.testing.assert_array_equal(_np(corr), rcorr)
    np.testing.assert_array_equal(_np(dec), data)           # corrected
    np.testing.assert_array_equal(_np(corr), (flip != 0).astype(np.uint32))


def test_every_single_bit_error_position_is_corrected():
    """Bit p of the codeword flipped in block p, for p = 0..30; bit 31 lies
    outside the codeword, is masked off and corrects nothing."""
    n_per = 64
    data = _words(32 * n_per, 5, bits=26)
    pos = np.repeat(np.arange(32, dtype=np.uint32), n_per)
    corrupted = jref.encode_ref(data) ^ (np.uint32(1) << pos)
    dec, corr = ops.hamming_decode(torch.from_numpy(corrupted))
    jdec, jcorr = jops.hamming_decode(jnp.asarray(corrupted))
    np.testing.assert_array_equal(_np(dec), np.asarray(jdec))
    np.testing.assert_array_equal(_np(corr), np.asarray(jcorr))
    np.testing.assert_array_equal(_np(dec), data)
    np.testing.assert_array_equal(_np(corr), (pos < 31).astype(np.uint32))


def test_double_bit_errors_are_miscorrected_as_the_reference_does():
    rng = np.random.default_rng(11)
    n = 4000
    data = _words(n, 12, bits=26)
    p1 = rng.integers(0, 31, size=n)
    p2 = (p1 + rng.integers(1, 31, size=n)) % 31          # distinct from p1
    flip = (np.uint32(1) << p1.astype(np.uint32)) | (
        np.uint32(1) << p2.astype(np.uint32))
    corrupted = jref.encode_ref(data) ^ flip
    dec, corr = ops.hamming_decode(torch.from_numpy(corrupted))
    jdec, jcorr = jops.hamming_decode(jnp.asarray(corrupted))
    rdec, rcorr = jref.decode_ref(corrupted)
    np.testing.assert_array_equal(_np(dec), np.asarray(jdec))
    np.testing.assert_array_equal(_np(corr), np.asarray(jcorr))
    np.testing.assert_array_equal(_np(dec), rdec)
    np.testing.assert_array_equal(_np(corr), rcorr)
    assert (_np(dec) != data).mean() > 0.5                # miscorrected
    assert _np(corr).all()                                # syndrome never 0


def test_decode_of_random_words_matches():
    """Words that are no codeword at all, bit 31 set in half of them."""
    words = _words(10000, 13)
    dec, corr = ops.hamming_decode(torch.from_numpy(words))
    jdec, jcorr = jops.hamming_decode(jnp.asarray(words))
    np.testing.assert_array_equal(_np(dec), np.asarray(jdec))
    np.testing.assert_array_equal(_np(corr), np.asarray(jcorr))


@pytest.mark.parametrize("constant", CONSTANTS)
def test_multiply_matches_jax_and_oracle(constant):
    data = _words(8192 + 3, abs(constant) % 1000)
    out = _np(ops.multiply_const(torch.from_numpy(data), constant))
    np.testing.assert_array_equal(out, np.asarray(jops.multiply_const(
        jnp.asarray(data), constant)))
    if constant >= 0:
        np.testing.assert_array_equal(out, jref.multiply_ref(data, constant))


def test_empty_streams():
    empty = np.zeros((0,), np.uint32)
    x = torch.from_numpy(empty)
    enc = ops.hamming_encode(x)
    dec, corr = ops.hamming_decode(x)
    mul = ops.multiply_const(x, 3)
    for out, want in ((enc, jref.encode_ref(empty)),
                      (dec, jref.decode_ref(empty)[0]),
                      (corr, jref.decode_ref(empty)[1]),
                      (mul, jref.multiply_ref(empty, 3))):
        assert out.dtype == torch.uint32 and out.shape == (0,)
        np.testing.assert_array_equal(_np(out), want)
    with pytest.raises(TypeError):
        jops.hamming_encode(jnp.asarray(empty))


@pytest.mark.parametrize("n", [1, 3, 5])
def test_multiply_at_short_lengths(n):
    data = _words(n, 17)
    np.testing.assert_array_equal(
        _np(ops.multiply_const(torch.from_numpy(data), 3)),
        np.asarray(jops.multiply_const(jnp.asarray(data), 3)))


def test_int32_and_int64_streams_are_the_same_words():
    data = _words(1000, 19)
    as_u32 = ops.hamming_encode(torch.from_numpy(data))
    as_i32 = ops.hamming_encode(torch.from_numpy(data.view(np.int32)))
    as_i64 = ops.hamming_encode(torch.from_numpy(data.astype(np.int64)))
    assert torch.equal(as_u32.view(torch.int32), as_i32.view(torch.int32))
    assert torch.equal(as_u32.view(torch.int32), as_i64.view(torch.int32))
    assert ops.multiply_const(torch.from_numpy(data), 3).dtype == torch.uint32


def test_plain_versions_take_int32_and_match_the_oracle():
    data = _words(5000, 23)
    x = torch.from_numpy(data.view(np.int32))
    np.testing.assert_array_equal(ref.encode_ref(x).numpy().view(np.uint32),
                                  ref.encode_np(data))
    d, c = ref.decode_ref(x)
    rd, rc = ref.decode_np(data)
    np.testing.assert_array_equal(d.numpy().view(np.uint32), rd)
    np.testing.assert_array_equal(c.numpy().view(np.uint32), rc)
    np.testing.assert_array_equal(
        ref.multiply_ref(x, 2654435761).numpy().view(np.uint32),
        ref.multiply_np(data, 2654435761))


def test_streams_are_one_dimensional():
    with pytest.raises(ValueError, match="1-D"):
        ops.hamming_encode(torch.zeros((2, 4), dtype=torch.int32))


def test_cuda_mode_with_cpu_tensors_raises_and_launches_nothing():
    x = torch.zeros(8, dtype=torch.int32)
    before = K.launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        K.hamming_encode(x, mode=KernelMode.CUDA)
    with pytest.raises(ValueError, match="CUDA"):
        K.hamming_decode(x, mode="pallas")
    with pytest.raises(ValueError, match="CUDA"):
        ops.multiply_const(x, 3, mode=KernelMode.CUDA)
    assert K.launch_counts() == before
    assert set(before) == {"hamming_encode", "hamming_decode", "mul_const"}
