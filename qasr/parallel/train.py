"""Mesh-sharded training: DP over "data", TP/FSDP weight sharding over "model".

The multi-device training the reference never had (SURVEY.md §2c): one
jit-compiled SPMD train step; GSPMD inserts psum for DP gradient reduction
and all-gather/reduce-scatter for the model-sharded weights, which XLA hands
to NCCL on GPUs. 1 card vs N hosts differ only in mesh construction.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from qasr.configs import Config
from qasr.parallel.mesh import DATA_AXIS
from qasr.parallel.sharding import batch_shardings, tree_shardings
from qasr.train.state import TrainState, build_model, build_optimizer
from qasr.train.step import make_loss_fn, optax_global_norm


def host_rows(tree):
    """This process' contiguous row-slice of a host-replicated global batch.

    Identity on a single process. Multi-host callers scoring step outputs
    (host-local views) against batch fields must slice the references with
    the SAME convention the step adapter uses (process-contiguous rows).
    """
    n_proc = jax.process_count()
    if n_proc == 1:
        return tree
    pidx = jax.process_index()

    def slc(v):
        b = v.shape[0]
        local = b // n_proc
        return v[pidx * local : (pidx + 1) * local]

    return jax.tree_util.tree_map(slc, tree)


def _data_axis_process_contiguous(mesh: Mesh) -> bool:
    """Whether each data-axis row lives on one process, with rows ordered by
    process index — the layout under which a process-contiguous slice of a
    host-replicated batch is that process's local shard view."""
    import numpy as np

    axis = mesh.axis_names.index(DATA_AXIS)
    rows = np.moveaxis(mesh.devices, axis, 0).reshape(mesh.shape[DATA_AXIS], -1)
    procs = []
    for row in rows:
        owners = {d.process_index for d in row}
        if len(owners) != 1:
            return False
        procs.append(next(iter(owners)))
    return procs == sorted(procs)


def _multihost_adapter(mesh: Mesh, step, out_specs=None):
    """Make a sharded step consumable with host-replicated numpy batches.

    Single-process: identity (jit's in_shardings place the arrays). Multi-host
    SPMD: every host's data iterator deterministically reproduces the same
    GLOBAL batch (same seed/dataset walk), so each host slices its own
    process-contiguous rows and assembles the global sharded array via
    multihost_utils; batch-sharded outputs convert back to the host-local
    view so callers can np.asarray them (out_specs gives the per-leaf
    PartitionSpecs; None leaves outputs untouched, e.g. replicated scalars
    and the train state).
    """
    if jax.process_count() == 1:
        return step

    if not _data_axis_process_contiguous(mesh):
        raise ValueError(
            "host-replicated batch adapter requires the mesh's data axis to "
            "be process-contiguous (each data row on one process, rows "
            "ordered by process); this mesh interleaves processes — build "
            "the step with adapt_host_batches=False and feed global arrays "
            "(multihost_utils.host_local_array_to_global_array)"
        )

    from jax.experimental import multihost_utils

    n_proc = jax.process_count()

    def wrapped(state_or_params, batch):
        b = next(iter(batch.values())).shape[0]
        if b % n_proc:
            raise ValueError(f"global batch {b} not divisible by {n_proc} hosts")
        batch = multihost_utils.host_local_array_to_global_array(
            host_rows(batch), mesh, P(DATA_AXIS)
        )
        out = step(state_or_params, batch)
        if out_specs is not None:
            out = multihost_utils.global_array_to_host_local_array(
                out, mesh, out_specs
            )
        return out

    return wrapped


def create_sharded_train_state(cfg: Config, rng: jax.Array, sample_features, mesh: Mesh):
    """Initialize the train state directly into its target shardings.

    jit-with-out_shardings means large models materialize each shard on its
    own device — the full state never exists unsharded anywhere.
    Returns (state, state_shardings).
    """
    model = build_model(cfg)
    tx = build_optimizer(cfg)

    def init_fn(rng, feats):
        p_rng, d_rng = jax.random.split(rng)
        params = model.init(p_rng, feats, train=False)["params"]
        return TrainState(
            step=jnp.zeros((), jnp.int32),
            params=params,
            opt_state=tx.init(params),
            dropout_rng=d_rng,
        )

    feats = jnp.asarray(sample_features)
    abstract = jax.eval_shape(init_fn, rng, feats)
    shardings = tree_shardings(mesh, abstract)
    state = jax.jit(init_fn, out_shardings=shardings)(rng, feats)
    return state, shardings


def make_sharded_train_step(
    cfg: Config,
    mesh: Mesh,
    state_shardings,
    sample_batch,
    *,
    adapt_host_batches: bool = True,
):
    """Build the pjit train step with explicit in/out shardings.

    ``adapt_host_batches=True`` (default) wraps the step so multi-host
    callers can feed host-replicated numpy batches; this requires the mesh's
    data axis to be process-contiguous (see _multihost_adapter). Pass False
    for meshes that interleave processes along the model axis and feed
    global jax.Arrays (e.g. via multihost_utils.host_local_array_to_
    global_array) yourself — tests/multihost_worker.py shows the pattern."""
    model = build_model(cfg)
    tx = build_optimizer(cfg)
    loss_fn = make_loss_fn(cfg, model)
    b_shardings = batch_shardings(mesh, sample_batch)

    @functools.partial(
        jax.jit,
        in_shardings=(state_shardings, b_shardings),
        out_shardings=(state_shardings, None),
        donate_argnums=(0,),
    )
    def train_step(state: TrainState, batch):
        rng = jax.random.fold_in(state.dropout_rng, state.step)
        (loss, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params, batch, rng, True
        )
        new_state = state.apply_gradients(grads, tx)
        metrics = {
            "loss": loss,
            "grad_norm": optax_global_norm(grads),
            "frames": batch["feature_lengths"].sum(),
        }
        return new_state, metrics

    if not adapt_host_batches:
        return train_step
    # outputs (state, replicated-scalar metrics) need no host-local view
    return _multihost_adapter(mesh, train_step)


def make_sharded_eval_step(cfg: Config, mesh: Mesh, state_shardings, sample_batch):
    from qasr.ops.ctc import ctc_greedy_decode

    model = build_model(cfg)
    loss_fn = make_loss_fn(cfg, model)
    b_shardings = batch_shardings(mesh, sample_batch)

    @functools.partial(
        jax.jit,
        in_shardings=(state_shardings.params, b_shardings),
    )
    def eval_step(params, batch):
        loss, logits = loss_fn(params, batch, jax.random.PRNGKey(0), False)
        decoded, dec_lens = ctc_greedy_decode(
            logits, batch["feature_lengths"], blank_id=cfg.decode.blank_id
        )
        return {"loss": loss, "decoded": decoded, "decoded_lengths": dec_lens}

    return _multihost_adapter(
        mesh,
        eval_step,
        out_specs={"loss": P(), "decoded": P(DATA_AXIS), "decoded_lengths": P(DATA_AXIS)},
    )


def make_sharded_beam_decode_step(cfg: Config, mesh: Mesh, state_shardings, sample_batch):
    """DP-sharded prefix beam-search decode (SURVEY.md §3.4, §2b R4).

    The eval set is data-parallel over the mesh: each device runs the
    fixed-shape jittable beam search (qasr.decode.beam) on its shard of
    utterances — beam state never crosses devices because prefix beams are
    per-utterance; what crosses hosts is only the PER counters, via
    qasr.parallel.collectives.aggregate_per. Sequences come back left-packed
    and -1-padded like the greedy path, so the same scoring code applies.

    Output dict matches make_beam_eval_step (incl. the CTC loss from the same
    single forward), so it drops into ``evaluate(..., beam_step=...)``.
    """
    from qasr.decode.beam import ctc_beam_search_decode

    model = build_model(cfg)
    loss_fn = make_loss_fn(cfg, model)
    b_shardings = batch_shardings(mesh, sample_batch)

    @functools.partial(
        jax.jit,
        in_shardings=(state_shardings.params, b_shardings),
    )
    def beam_step(params, batch):
        loss, logits = loss_fn(params, batch, jax.random.PRNGKey(0), False)
        seq, lens, score = ctc_beam_search_decode(
            logits,
            batch["feature_lengths"],
            beam_width=cfg.decode.beam_width,
            blank_id=cfg.decode.blank_id,
            max_len=int(cfg.data.max_label_len),
            prune_logp=cfg.decode.beam_prune_logp,
        )
        return {
            "loss": loss,
            "decoded": seq,
            "decoded_lengths": lens,
            "log_score": score,
        }

    return _multihost_adapter(
        mesh,
        beam_step,
        out_specs={
            "loss": P(),
            "decoded": P(DATA_AXIS),
            "decoded_lengths": P(DATA_AXIS),
            "log_score": P(DATA_AXIS),
        },
    )
