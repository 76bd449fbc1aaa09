"""Jitted train/eval steps: forward + CTC + Adam update in one dispatch.

The reference's hot loop is Keras `fit_generator` dispatching per-batch into
the backend graph (SURVEY.md §3.1). Here: ONE jit-compiled
``train_step(state, batch) -> (state, metrics)`` containing forward, native
CTC, and the optax update — a single device dispatch per step, donated input
state, optional rematerialization of the conv stack.
"""

from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp

from qasr.configs import Config
from qasr.ops.ctc import ctc_greedy_decode, ctc_loss
from qasr.train.state import TrainState, build_model, build_optimizer


def make_loss_fn(cfg: Config, model) -> Callable:
    blank = cfg.decode.blank_id

    def fwd_train(params, features, lengths, dropout_rng):
        return model.apply(
            {"params": params},
            features,
            train=True,
            lengths=lengths,
            rngs={"dropout": dropout_rng},
        )

    if cfg.train.remat_convs:
        # rematerialize the encoder in backward: trade FLOPs for memory
        # (SURVEY.md environment notes: jax.checkpoint on the conv stack)
        fwd_train = jax.checkpoint(fwd_train)

    def loss_fn(params, batch, dropout_rng, train: bool):
        if train:
            logits = fwd_train(
                params, batch["features"], batch["feature_lengths"], dropout_rng
            )
        else:
            logits = model.apply(
                {"params": params},
                batch["features"],
                train=False,
                lengths=batch["feature_lengths"],
            )
        losses = ctc_loss(
            logits,
            batch["labels"],
            batch["feature_lengths"],
            batch["label_lengths"],
            blank_id=blank,
        )
        # normalize per label token (standard CTC reporting); guard empties.
        # real_rows (when present) masks remainder-batch pad rows out of both
        # numerator and denominator — pads must not bias the per-token loss
        # (reference protocol scores each utterance once).
        label_lens = batch["label_lengths"]
        mask = batch.get("real_rows")
        if mask is not None:
            losses = losses * mask
            label_lens = label_lens * mask
        denom = jnp.maximum(label_lens.sum(), 1)
        loss = losses.sum() / denom
        return loss, logits

    return loss_fn


def make_train_step(cfg: Config):
    """Build the jitted train step. Donates `state` so params update in place
    in device memory (no double-buffering of the full train state)."""
    model = build_model(cfg)
    tx = build_optimizer(cfg)
    loss_fn = make_loss_fn(cfg, model)

    @functools.partial(jax.jit, donate_argnums=(0,))
    def train_step(state: TrainState, batch):
        rng = jax.random.fold_in(state.dropout_rng, state.step)
        (loss, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params, batch, rng, True
        )
        new_state = state.apply_gradients(grads, tx)
        gnorm = optax_global_norm(grads)
        metrics = {
            "loss": loss,
            "grad_norm": gnorm,
            "frames": batch["feature_lengths"].sum(),
        }
        return new_state, metrics

    return train_step


@functools.lru_cache(maxsize=None)
def make_eval_step(cfg: Config):
    model = build_model(cfg)
    loss_fn = make_loss_fn(cfg, model)
    blank = cfg.decode.blank_id

    @jax.jit
    def eval_step(params, batch):
        loss, logits = loss_fn(params, batch, jax.random.PRNGKey(0), False)
        decoded, dec_lens = ctc_greedy_decode(
            logits, batch["feature_lengths"], blank_id=blank
        )
        return {
            "loss": loss,
            "decoded": decoded,
            "decoded_lengths": dec_lens,
        }

    return eval_step


@functools.lru_cache(maxsize=None)
def make_beam_eval_step(cfg: Config):
    """Eval step for the final-numbers protocol (SURVEY.md §3.4): ONE forward
    computing both the CTC loss and prefix beam-search decode. lru_cached on
    the (frozen) config so repeated ``evaluate(beam=True)`` calls reuse the
    jitted step instead of recompiling a fresh closure. For mesh-sharded eval
    use qasr.parallel.make_sharded_beam_decode_step, which returns the same
    output dict."""
    from qasr.decode.beam import ctc_beam_search_decode

    model = build_model(cfg)
    loss_fn = make_loss_fn(cfg, model)

    @jax.jit
    def beam_eval_step(params, batch):
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

    return beam_eval_step


def optax_global_norm(tree) -> jnp.ndarray:
    leaves = jax.tree_util.tree_leaves(tree)
    return jnp.sqrt(sum(jnp.sum(jnp.square(x.astype(jnp.float32))) for x in leaves))
