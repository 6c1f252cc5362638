"""Checkpoint/resume tests: full MC state round-trips and the resumed
chain continues identically."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mlmcpathintegral.lattice import Lattice1D
from mlmcpathintegral.models import HarmonicOscillatorAction
from mlmcpathintegral.samplers import HMCSampler
from mlmcpathintegral.utils import statistics as stats_mod
from mlmcpathintegral.utils.checkpoint import (
    checkpoint_metadata, load_checkpoint, save_checkpoint,
)
from mlmcpathintegral.utils.statistics import Statistics


def test_roundtrip_and_identical_continuation(tmp_path):
    lat = Lattice1D(16, 4.0)
    action = HarmonicOscillatorAction(lat, m0=1.0, mu2=1.0)
    sampler = HMCSampler(action, nt=8, dt=0.1)
    stats = Statistics("Q", 10)
    C = 16
    key = jax.random.PRNGKey(0)
    sstate = sampler.init(key, C, jnp.float64)
    st = stats.init(C, jnp.float64)
    for i in range(5):
        sstate, _ = sampler.draw(jax.random.fold_in(key, i), sstate)
        st = stats_mod.record(st, jnp.mean(sstate.x**2, axis=-1))

    ckpt = tmp_path / "chain.npz"
    save_checkpoint(ckpt, {"sampler": sstate, "stats": st,
                           "key": jax.random.key_data(key)},
                    metadata={"step": 5})
    assert checkpoint_metadata(ckpt)["step"] == 5

    template = {"sampler": sampler.init(jax.random.PRNGKey(9), C,
                                        jnp.float64),
                "stats": stats.init(C, jnp.float64),
                "key": jax.random.key_data(jax.random.PRNGKey(9))}
    restored = load_checkpoint(ckpt, template)
    np.testing.assert_array_equal(np.asarray(restored["sampler"].x),
                                  np.asarray(sstate.x))
    np.testing.assert_array_equal(np.asarray(restored["stats"].S_k),
                                  np.asarray(st.S_k))

    # continuation from restored state is bit-identical
    s_a, _ = sampler.draw(jax.random.fold_in(key, 99), sstate)
    s_b, _ = sampler.draw(jax.random.fold_in(key, 99), restored["sampler"])
    np.testing.assert_array_equal(np.asarray(s_a.x), np.asarray(s_b.x))


def test_shape_mismatch_raises(tmp_path):
    ckpt = tmp_path / "x.npz"
    save_checkpoint(ckpt, {"a": jnp.zeros((4, 4))})
    with pytest.raises(ValueError, match="shape mismatch"):
        load_checkpoint(ckpt, {"a": jnp.zeros((2, 2))})
    with pytest.raises(ValueError, match="leaves"):
        load_checkpoint(ckpt, {"a": jnp.zeros((4, 4)),
                               "b": jnp.zeros(3)})
