"""Inverse-rendering optimization loop with checkpoint/resume.

The reference's only checkpoint mechanism is the BVH cache
(Renderer.cc:157-217, reproduced in bvh/cache.py).  The differentiable
path adds a real optimization loop — fit vertex positions and
materials to a target image by gradient descent — and with it the
production concern the reference never had: persisting OPTIMIZER state
so a preempted run resumes exactly (step counter, optax moments, params)
rather than restarting.  Checkpoints are orbax (the standard JAX
checkpointing library), so they are sharding-aware if the params are
ever sharded.

Determinism contract (tested): resume-from-step-k followed by (n-k)
steps produces bit-identical params to an uninterrupted n-step run —
the train step is a pure jitted function of (state, batch).
"""

from __future__ import annotations

import os
from functools import partial
from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp
import optax

from tpu_rt.diff.shading import render_image_diff


class TrainState(NamedTuple):
    step: jnp.ndarray        # i32 scalar
    vtx_pos: jnp.ndarray     # [V,3] f32 (optimized)
    tri_material: jnp.ndarray  # [T,4] f32 (optimized)
    opt_state: tuple         # optax state pytree


def make_optimizer(lr: float = 1e-2):
    return optax.adam(lr)


def init_state(vtx_pos, tri_material, lr: float = 1e-2) -> TrainState:
    opt = make_optimizer(lr)
    params = (jnp.asarray(vtx_pos), jnp.asarray(tri_material))
    return TrainState(step=jnp.int32(0), vtx_pos=params[0],
                      tri_material=params[1],
                      opt_state=opt.init(params))


@partial(jax.jit, static_argnames=("lr",))
def train_step(state: TrainState, flat, rays, tri_vtx_index, target,
               lr: float = 1e-2) -> tuple:
    """One pure optimization step: render -> L2 image loss -> adam.
    Returns (new_state, loss).  Traversal routing is discrete (see
    diff/tracer.py) so gradients flow through the hit recompute only."""
    opt = make_optimizer(lr)

    def loss_fn(params):
        vp, mat = params
        rgb = render_image_diff(flat, rays, vp, tri_vtx_index, mat)
        return jnp.mean((rgb - target) ** 2)

    params = (state.vtx_pos, state.tri_material)
    loss, grads = jax.value_and_grad(loss_fn)(params)
    updates, opt_state = opt.update(grads, state.opt_state, params)
    vp, mat = optax.apply_updates(params, updates)
    return TrainState(step=state.step + 1, vtx_pos=vp, tri_material=mat,
                      opt_state=opt_state), loss


def _manager(ckpt_dir: str, max_to_keep: int = 3):
    import orbax.checkpoint as ocp

    return ocp.CheckpointManager(
        os.path.abspath(ckpt_dir),
        options=ocp.CheckpointManagerOptions(max_to_keep=max_to_keep))


def save_checkpoint(ckpt_dir: str, state: TrainState) -> None:
    import orbax.checkpoint as ocp

    mgr = _manager(ckpt_dir)
    mgr.save(int(state.step), args=ocp.args.StandardSave(
        {"step": state.step, "vtx_pos": state.vtx_pos,
         "tri_material": state.tri_material, "opt_state": state.opt_state}))
    mgr.wait_until_finished()
    mgr.close()


def restore_checkpoint(ckpt_dir: str, template: TrainState):
    """Latest checkpoint as a TrainState, or None if none exists."""
    import orbax.checkpoint as ocp

    mgr = _manager(ckpt_dir)
    step = mgr.latest_step()
    if step is None:
        mgr.close()
        return None
    tmpl = {"step": template.step, "vtx_pos": template.vtx_pos,
            "tri_material": template.tri_material,
            "opt_state": template.opt_state}
    restored = mgr.restore(step, args=ocp.args.StandardRestore(tmpl))
    mgr.close()
    return TrainState(step=jnp.asarray(restored["step"]),
                      vtx_pos=jnp.asarray(restored["vtx_pos"]),
                      tri_material=jnp.asarray(restored["tri_material"]),
                      opt_state=jax.tree_util.tree_map(
                          jnp.asarray, restored["opt_state"]))


def fit(flat, rays, tri_vtx_index, target, vtx_pos, tri_material,
        steps: int, lr: float = 1e-2, ckpt_dir: str | None = None,
        save_every: int = 0) -> tuple:
    """Run (or resume) the optimization for `steps` TOTAL steps.

    With ckpt_dir set, restores the latest checkpoint first and saves
    every `save_every` steps (and at the end), so a killed run resumes
    where it stopped.  Returns (state, losses list for the steps run
    in this call)."""
    state = init_state(vtx_pos, tri_material, lr)
    if ckpt_dir is not None:
        restored = restore_checkpoint(ckpt_dir, state)
        if restored is not None:
            state = restored
    target = jnp.asarray(target)
    losses = []
    while int(state.step) < steps:
        state, loss = train_step(state, flat, rays, tri_vtx_index, target,
                                 lr=lr)
        losses.append(float(loss))
        if (ckpt_dir is not None and save_every
                and int(state.step) % save_every == 0):
            save_checkpoint(ckpt_dir, state)
    if ckpt_dir is not None and (not save_every
                                 or int(state.step) % save_every):
        save_checkpoint(ckpt_dir, state)
    return state, losses
