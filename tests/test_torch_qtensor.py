"""The port's quantized format against the reference, byte for byte."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.quant import qtensor as jq
from repro_torch.quant import qtensor as tq
from torch_threads import _one_thread  # noqa: F401


def _weights(seed=0, shape=(3, 256, 64)):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(shape).astype(np.float32)
    w[:, :, 5] = 0.0                       # an all-zero column (scale 1)
    w[:, :64, 9] *= 1e3                    # a column with an outlier group
    return w


def _pair(w):
    jw = jnp.asarray(w, jnp.bfloat16)
    tw = torch.from_numpy(np.asarray(jw).view(np.uint16).copy()) \
        .view(torch.bfloat16)
    return jw, tw


def _u16(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(np.uint16)


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_byte_equal(bits, seed):
    jw, tw = _pair(_weights(seed))
    j = jq.quantize(jw, bits=bits, group_size=64)
    t = tq.quantize(tw, bits, 64)
    np.testing.assert_array_equal(np.asarray(j.packed), t.packed.numpy())
    np.testing.assert_array_equal(np.asarray(j.scales).view(np.uint16),
                                  _u16(t.scales))
    assert t.shape == tuple(j.shape)
    assert t.nbytes == j.nbytes


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_unpack_and_dequant_match(bits):
    jw, tw = _pair(_weights(2))
    j = jq.quantize(jw, bits=bits, group_size=64)
    t = tq.quantize(tw, bits, 64)
    k = jw.shape[-2]
    np.testing.assert_array_equal(np.asarray(jq.unpack_bits(j.packed, bits, k)),
                                  tq.unpack_bits(t.packed, bits, k).numpy())
    np.testing.assert_array_equal(np.asarray(jq.unpack_codes_int8(j.packed,
                                                                  bits)),
                                  tq.unpack_codes_int8(t.packed, bits).numpy())
    # Exact: codes × bf16 scales are exact in float32 before the bf16 cast.
    np.testing.assert_array_equal(
        np.asarray(jq.dequant_arrays(j.packed, j.scales, bits, 64))
        .view(np.uint16),
        _u16(tq.dequant_arrays(t.packed, t.scales, bits, 64)))


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_pack_roundtrip(bits):
    rng = np.random.default_rng(3)
    u = torch.from_numpy(rng.integers(0, 1 << bits, (2, 64, 16))
                         .astype(np.uint8))
    packed = tq.pack_bits(u, bits)
    assert packed.shape == (2, 64 // (8 // bits), 16)
    assert torch.equal(tq.unpack_bits(packed, bits, 64), u.to(torch.int32))


def test_layer_slice_keeps_layout():
    jw, tw = _pair(_weights(4, (2, 3, 128, 64)))
    t = tq.quantize(tw, 4, 64)
    one = t[1]
    assert one.shape == (3, 128, 64)
    assert torch.equal(one.packed, t.packed[1])
    assert torch.equal(one.scales, t.scales[1])
