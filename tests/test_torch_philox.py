"""The port's Philox normal generator (plain version, through the wrapper
on CPU tensors): Random123's published known-answer vectors, the JAX
package's Box-Muller transform, the TPU probe's moment gate, and the
independence of the stream from the block drawn."""
import numpy as np
import pytest
import torch

from sgmcmc_tpu_torch.ops.cuda import philox

torch.set_num_threads(1)

# philox4x32-10 known-answer vectors of Random123 (kat_vectors):
# (counter, key) -> output
KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
]


@pytest.mark.parametrize("counter,key,want", KAT)
def test_philox_known_answer_vectors(counter, key, want):
    def t(words):
        return [torch.tensor(w, dtype=torch.int64) for w in words]
    got = philox.philox4x32_reference(t(counter), t(key))
    assert [int(w) for w in got] == list(want)


def numpy_box_muller(b1, b2):
    """A numpy transcription of _box_muller
    (sgmcmc_tpu/ops/pallas/fused_pf.py) in float32."""
    f = np.float32
    u1 = ((b1 & 0x7fffff).astype(f) + f(0.5)) * f(2.0 ** -23)
    u2 = ((b2 & 0x7fffff).astype(f) + f(0.5)) * f(2.0 ** -23)
    return np.sqrt(f(-2.0) * np.log(u1)) * np.cos(
        f(2.0 * 3.14159265358979) * u2)


def test_box_muller_matches_numpy_transcription():
    """Same bits, same float32 operations; tolerance 2e-6 relative for the
    two libraries' log and cos (both within an ulp or two)."""
    seeds = torch.tensor([11, -3, 2 ** 40 + 5])
    words = philox.philox_words_reference(seeds, 4, 2, 33).numpy()
    want = numpy_box_muller(words[..., 0].astype(np.uint32),
                            words[..., 1].astype(np.uint32))
    got = philox.philox_normals_reference(seeds, 4, 2, 33).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)
    # the extreme uniforms: the largest |z| the transform can give
    top = numpy_box_muller(np.array([0], np.uint32), np.array([0], np.uint32))
    assert np.all(np.abs(got) <= top[0] + 1e-5)


def test_normals_pass_the_probe_gate():
    """K4's shape (256 x 512) and the gate of
    scripts/tpu_probe_kernel_rng.py: |mean| < 0.02, |std - 1| < 0.02,
    |kurtosis - 3| < 0.2; deterministic in the seed and changed by it."""
    def draw(seed):
        return philox.philox_normals(torch.tensor([seed]), 256, 1, 512)[0, :, 0]
    z = draw(123).double().numpy()
    assert z.shape == (256, 512)
    k = np.mean(((z - z.mean()) / z.std()) ** 4)
    assert abs(z.mean()) < 0.02 and abs(z.std() - 1) < 0.02 and abs(k - 3) < 0.2
    assert torch.equal(draw(123), draw(123))
    assert not torch.equal(draw(123), draw(124))


def test_sub_block_equals_slice_of_full_draw():
    """The stream is a function of (seed, t, q, i, stream) only: chains,
    steps and particles drawn alone equal the same slice of a full draw,
    and the two streams differ."""
    seeds = torch.tensor([5, 6, 7, -8])
    full = philox.philox_normals(seeds, 6, 2, 11)
    part = philox.philox_normals(seeds[1:3], 2, 2, 6, t0=3)
    assert torch.equal(part, full[1:3, 3:5, :, :6])
    words = philox.philox_words(seeds, 6, 2, 11)
    assert torch.equal(philox.philox_words(seeds[2:], 1, 2, 11, t0=5),
                       words[2:, 5:])
    assert words.min() >= 0 and words.max() <= philox.MASK
    init = philox.philox_normals(seeds, 6, 2, 11,
                                 stream=philox.STREAM_INIT)
    assert not torch.equal(init, full)


def test_wrapper_runs_the_plain_version_on_cpu_only():
    seeds = torch.tensor([1, 2])
    before = philox.philox_normals.launches
    assert torch.equal(philox.philox_normals(seeds, 2, 1, 8),
                       philox.philox_normals_reference(seeds, 2, 1, 8))
    assert philox.philox_normals.launches == before
    with pytest.raises(ValueError, match="no Philox kernel"):
        philox.philox_normals(seeds.to("meta"), 2, 1, 8)
