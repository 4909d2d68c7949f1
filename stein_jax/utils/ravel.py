"""Pytree <-> flat particle-matrix conversion.

Replacement for the reference's dict<->array converters
(stein/utilities/converters.py:4-89): particles live as a single [n, p]
matrix on device; each row unravels into the model's parameter pytree for
the log-posterior/gradient computation. JAX's dict flattening sorts keys,
matching the reference's sort-variables-by-name layout (converters.py:40),
so column order is deterministic.
"""

import numpy as np

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree


def template_unraveler(template, dtype=None):
    """Given a parameter-pytree template, return (n_params, unravel_fn).

    ``unravel_fn`` maps a flat [p] vector back to the template's structure.
    If ``dtype`` is given, template leaves are cast first so the flat vector
    has a uniform dtype.
    """
    if dtype is not None:
        template = jax.tree_util.tree_map(
            lambda x: jnp.asarray(x, dtype), template
        )
    flat, unravel = ravel_pytree(template)
    return flat.size, unravel


def ravel_particles(theta_tree):
    """Pytree of [n, *shape] leaves -> [n, p] matrix (rows = particles)."""
    return jax.vmap(lambda t: ravel_pytree(t)[0])(theta_tree)


def unravel_particles(theta_array, unravel_fn):
    """[n, p] matrix -> pytree of [n, *shape] leaves."""
    return jax.vmap(unravel_fn)(theta_array)


def init_particles(key, n_particles, n_params, dtype, scale=0.01):
    """0.01 * N(0, I) init (reference: abstract_stein_sampler.py:66-74)."""
    return scale * jax.random.normal(key, (n_particles, n_params), dtype)


def convert_dictionary_to_array(dictionary):
    """Reference-compatible converter (converters.py:4-55): a dict of
    {name: [n_particles, *shape]} arrays -> ([n_particles, n_params]
    matrix, access_indices {name: (start, end)}), keys in sorted order for
    a deterministic column layout (converters.py:40)."""
    keys = sorted(dictionary.keys())
    n_particles = next(iter(dictionary.values())).shape[0]
    parts, access_indices, index = [], {}, 0
    for k in keys:
        v = jnp.asarray(dictionary[k])
        dim = int(np.prod(v.shape[1:])) if v.ndim > 1 else 1
        parts.append(v.reshape(n_particles, dim))
        access_indices[k] = (index, index + dim)
        index += dim
    return jnp.concatenate(parts, axis=1), access_indices


def convert_array_to_dictionary(array, access_indices, shapes):
    """Inverse of convert_dictionary_to_array (converters.py:58-89).

    ``shapes`` maps each name to its per-particle shape (the reference
    recovers these from the TF variables; here they are explicit)."""
    n_particles = array.shape[0]
    return {
        k: array[:, s:e].reshape((n_particles,) + tuple(shapes[k]))
        for k, (s, e) in access_indices.items()
    }
