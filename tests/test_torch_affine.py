"""Random biases and norm affines for the port's composite parity tests.

The models' own init (the JAX package's and the port's alike) zeroes every
bias and gives every LayerNorm / GroupNorm unit scale and zero shift, so a
fault in how a kernel's epilogue adds a bias, or how a fused LayerNorm or
GroupNorm applies its scale and shift, cancels out in any comparison built
on that init. ``random_affine`` overwrites them, from a numpy seed, in a JAX
parameter tree held as numpy arrays (``jax.tree.map(np.asarray, params)``),
before the tree is loaded into the port, so both sides run the same
values. The UNet, transformer-block, VAE and pipeline parity tests take it
as a second case (``init`` / ``random_affine``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

# a bias ~ N(0, BIAS_STD^2); a norm's scale ~ 1 + N(0, SCALE_STD^2) and its
# shift ~ N(0, BIAS_STD^2): large enough that a dropped or misplaced term
# moves an O(1) activation by ~10%, small enough that the towers stay in the
# range of the init's activations
BIAS_STD, SCALE_STD = 0.1, 0.1
INITS = ("init", "random_affine")


def random_affine(tree, seed: int):
    """A copy of ``tree`` (nested dicts / lists of numpy arrays) with every
    ``bias`` leaf drawn anew and every ``scale`` leaf (a norm's: its sibling
    is its shift, ``bias``) drawn around 1; every other leaf is the same
    object. Leaves keep their dtypes; a bias exists only where the layer
    has one, so none is added."""
    rng = np.random.default_rng(seed)

    def walk(t):
        if isinstance(t, dict):
            out = {}
            for k in sorted(t, key=str):
                v = t[k]
                if k == "bias" and not isinstance(v, (dict, list, tuple)):
                    v = (rng.standard_normal(v.shape) * BIAS_STD).astype(
                        v.dtype)
                elif k == "scale" and not isinstance(v, (dict, list, tuple)):
                    v = (1.0 + rng.standard_normal(v.shape) * SCALE_STD
                         ).astype(v.dtype)
                else:
                    v = walk(v)
                out[k] = v
            return {k: out[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        return t

    return walk(tree)


def params_for(init: str, jparams, seed: int):
    """The numpy tree of ``jparams`` for a parity case: as initialized, or
    with ``random_affine(seed)``."""
    tree = jax.tree.map(np.asarray, jparams)
    return tree if init == "init" else random_affine(tree, seed)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_random_affine_draws_every_bias_and_norm(dtype):
    from idmvton_tpu.models import attention as jatt
    jp = jatt.init_transformer_block(jax.random.PRNGKey(0), 32, heads=2,
                                     head_dim=16, context_dim=24,
                                     ip_adapter=True, dtype=dtype)
    tree = jax.tree.map(np.asarray, jp)
    got = dict(_leaves(random_affine(tree, 1)))
    want = dict(_leaves(tree))
    assert got.keys() == want.keys()
    n_bias = n_scale = 0
    for path, leaf in want.items():
        new = got[path]
        assert new.shape == leaf.shape and new.dtype == leaf.dtype
        if path[-1] == "bias":
            n_bias += 1
            assert not np.array_equal(new, leaf)
            assert float(np.abs(new.astype(np.float32)).max()) < 1.0
        elif path[-1] == "scale":
            n_scale += 1
            assert abs(float(new.astype(np.float32).mean()) - 1.0) < 0.1
            assert not np.array_equal(new, leaf)
        else:
            assert new is leaf
    # three norms (scale, shift); to_out and ff biases, none on to_qkv
    assert n_scale == 3 and n_bias == 3 + 4
    assert ("attn1", "to_qkv", "bias") not in got
    # the same seed draws the same values
    again = dict(_leaves(random_affine(tree, 1)))
    assert all(np.array_equal(again[p], got[p]) for p in got)
