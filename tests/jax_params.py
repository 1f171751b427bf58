"""The JAX package's parameters for the port's parity tests.

``init_params`` is the one program that builds a JAX model's parameters
here: its jitted training-mode ``init``.  For the same config it is the
same XLA program in every test file, so the persistent compilation cache
(``tests/.jax_cache``) compiles it once in a run, whichever file asks
first.  ``wake`` gives seeded values to the leaves an init leaves at zero,
so that no branch adds exactly 0.
"""

import jax
import jax.numpy as jnp
import numpy as np


# LLVM at -O1 instead of -O2: the init compiles on about half the CPU time
# (126 → 73 CPU-seconds for ``net_ga`` at ``n_override=32``, most of it the
# initializers' ~700 threefry loops), and its parameters are the -O2
# program's bit for bit (checked for every config the tests build here).
_INIT_COMPILER_OPTIONS = {"xla_backend_optimization_level": 1}


def init_params(jm, seed=0):
    """``jm``'s parameters from its jitted training-mode ``init`` on a
    1×64×64 image of zeros (no parameter's shape depends on the image's),
    as numpy arrays."""
    init = jax.jit(lambda k: jm.init({"params": k, "noise": jax.random.PRNGKey(1)},
                                     jnp.zeros((1, 64, 64, 3)), training=True),
                   compiler_options=_INIT_COMPILER_OPTIONS)
    return jax.tree.map(np.array, jax.device_get(init(jax.random.PRNGKey(seed))["params"]))


def wake(tree, seed, where=None):
    """``tree`` as numpy arrays, every all-zero leaf (of those whose
    "/"-joined path ``where`` takes, if given) drawn from N(0, 0.05²) in
    float32, in the tree's leaf order.  The tree comes to the host in one
    ``device_get``."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        key = "/".join(str(getattr(p, "key", p)) for p in path)
        if a.any() or (where is not None and not where(key)):
            return np.array(a)
        return (rng.standard_normal(a.shape) * 0.05).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, jax.device_get(tree))
