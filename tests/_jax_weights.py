"""Seeded JAX weights for the port's parity tests.

``jax_init(model, seed)`` is the JAX package's ``model.init`` at
``PRNGKey(seed)``, compiled once per model (``Model`` is a frozen, hashable
dataclass) and at XLA's lowest optimisation level: a reduced model's init
is a long chain of random draws that the default pipeline spends seconds
optimising, while a test needs only one set of weights that both packages
share (the port's through ``repro_torch.convert``)."""
import functools

import jax

_CHEAP = {"xla_backend_optimization_level": 0,
          "xla_llvm_disable_expensive_passes": True}


@functools.lru_cache(maxsize=None)
def _compiled_init(model):
    return jax.jit(model.init).lower(jax.random.PRNGKey(0)).compile(
        compiler_options=_CHEAP)


def jax_init(model, seed: int):
    """``model.init(jax.random.PRNGKey(seed))``, compiled cheaply once."""
    return _compiled_init(model)(jax.random.PRNGKey(seed))
