"""Checkpoint / resume for the full sampler state.

The reference has no checkpointing (SURVEY.md §5): a crash loses all state.
Here the entire mutable state is the SVGDState pytree {particles, optimizer
moments, step count} plus the decayed learning rate inside the optimizer
state — saved as a flat .npz, restored sharding-aware by re-placing each
leaf with the sharding of a template state (so a multi-host run restores
straight back onto its mesh).

Format: leaves ``leaf_0..leaf_k`` plus a ``__meta__`` record carrying a
format version and a structural signature (the treedef string + per-leaf
key paths). Restore rejects a checkpoint whose signature disagrees with
the template — same-shaped leaves that swapped positions after a refactor
(e.g. mu/nu) would otherwise restore silently wrong.
"""

import numpy as np
import jax

CHECKPOINT_FORMAT_VERSION = 2


def _state_signature(state):
    """Structural signature: ordered per-leaf key paths (e.g.
    '.opt_state.mu') — a rename or reorder of pytree fields changes it."""
    paths = [
        jax.tree_util.keystr(path)
        for path, _ in jax.tree_util.tree_flatten_with_path(state)[0]
    ]
    return "|".join(paths)


def save_checkpoint(path, state):
    """Serialise a state pytree to ``path`` (npz format; the file lands at
    exactly ``path`` regardless of extension).

    Writes through a side-named temp file so np.savez's implicit '.npz'
    suffix can never clobber an unrelated ``path + '.npz'`` file, and the
    final rename is atomic."""
    import os
    from .hostio import host_array
    leaves, _ = jax.tree_util.tree_flatten(state)
    # The allgather inside host_array is collective: every process in a
    # multi-controller job must reach this point...
    arrays = {f"leaf_{i}": host_array(leaf) for i, leaf in enumerate(leaves)}
    arrays["__meta__"] = np.array(
        [str(CHECKPOINT_FORMAT_VERSION), _state_signature(state)]
    )
    # ...but only process 0 writes (on shared storage N racing writers of
    # the same path would be redundant at best).
    if jax.process_index() != 0:
        return
    tmp = str(path) + f".saving{os.getpid()}"
    np.savez(tmp, **arrays)             # np.savez writes tmp + '.npz'
    written = tmp if os.path.exists(tmp) else tmp + ".npz"
    os.replace(written, path)


def restore_checkpoint(path, like_state):
    """Restore a state pytree saved by save_checkpoint.

    ``like_state`` supplies the tree structure, dtypes, and shardings; each
    restored leaf is device_put with the corresponding template leaf's
    sharding, so restoring onto a mesh-sharded sampler lands the particles
    back on their shards. Raises ValueError if the checkpoint's structural
    signature (format version + leaf key paths) disagrees with the
    template."""
    data = np.load(path)
    like_leaves, treedef = jax.tree_util.tree_flatten(like_state)
    if "__meta__" not in data.files:
        # r3 review: silently skipping validation here restored
        # pre-v2 / truncated / foreign npz files purely by position —
        # exactly the silent leaf-swap failure the signature exists to
        # reject (the module docstring's guarantee).
        raise ValueError(
            f"checkpoint {path} has no __meta__ record — not a "
            f"stein_jax v{CHECKPOINT_FORMAT_VERSION} checkpoint (or "
            "truncated); positional restore without the structural "
            "signature would be silently wrong"
        )
    version, signature = data["__meta__"]
    if int(version) != CHECKPOINT_FORMAT_VERSION:
        raise ValueError(
            f"checkpoint format version {version} != supported "
            f"{CHECKPOINT_FORMAT_VERSION}"
        )
    want = _state_signature(like_state)
    if signature != want:
        raise ValueError(
            "checkpoint structure does not match the template state:\n"
            f"  checkpoint: {signature}\n"
            f"  template:   {want}\n"
            "(a refactor reordered or renamed state leaves; restoring "
            "by position would be silently wrong)"
        )
    n_leaf = len([f for f in data.files if f.startswith("leaf_")])
    if n_leaf != len(like_leaves):
        raise ValueError(
            f"checkpoint has {n_leaf} leaves, template has "
            f"{len(like_leaves)}"
        )
    restored = []
    for i, like in enumerate(like_leaves):
        arr = data[f"leaf_{i}"]
        if arr.shape != like.shape:
            raise ValueError(
                f"leaf {i}: checkpoint shape {arr.shape} != template "
                f"shape {like.shape}"
            )
        arr = arr.astype(like.dtype)
        sharding = getattr(like, "sharding", None)
        if sharding is not None:
            # Multi-controller-safe placement (device_put cannot address
            # remote shards of a cross-process mesh).
            from ..parallel.sharded import _place_global
            restored.append(_place_global(arr, sharding))
        else:
            restored.append(jax.device_put(arr))
    return jax.tree_util.tree_unflatten(treedef, restored)
