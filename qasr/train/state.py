"""Train state construction: model, optimizer, LR schedule.

Reference capability: Adam + fixed hyperparameters in the Keras train script
(SURVEY.md §2a C11; mount empty). Here: optax adamw with warmup+cosine
schedule, global-norm clipping, and a single pytree TrainState that
qasr.train.checkpoint saves in full (params, opt state, step, PRNG key) —
SURVEY.md §5 checkpoint/resume plan.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import optax

from qasr import nn
from qasr.configs import Config
from qasr.models.qcnn import QCNNEncoder, RealCNNEncoder


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TrainState:
    step: jnp.ndarray
    params: Any
    opt_state: Any
    dropout_rng: jax.Array

    def replace(self, **changes) -> "TrainState":
        return dataclasses.replace(self, **changes)

    def apply_gradients(self, grads, tx):
        updates, new_opt = tx.update(grads, self.opt_state, self.params)
        return self.replace(
            step=self.step + 1,
            params=optax.apply_updates(self.params, updates),
            opt_state=new_opt,
            dropout_rng=jax.random.fold_in(self.dropout_rng, self.step),
        )


def build_model(cfg: Config) -> nn.Module:
    m = cfg.model
    dtype = jnp.bfloat16 if m.compute_dtype == "bfloat16" else jnp.float32
    if m.arch == "qcnn":
        return QCNNEncoder(
            conv_features=tuple(m.conv_features),
            dense_features=tuple(m.dense_features),
            vocab=m.vocab,
            kernel_size=tuple(m.kernel_size),
            pool_after=m.pool_after,
            pool_size=m.pool_size,
            dropout_rate=m.dropout_rate,
            dtype=dtype,
            variant=m.op_variant,
            dense_variant=m.dense_variant,
        )
    if m.arch == "real_cnn":
        return RealCNNEncoder(
            conv_features=tuple(m.conv_features),
            dense_features=tuple(m.dense_features),
            vocab=m.vocab,
            kernel_size=tuple(m.kernel_size),
            pool_after=m.pool_after,
            pool_size=m.pool_size,
            dropout_rate=m.dropout_rate,
            dtype=dtype,
        )
    if m.arch == "qlstm":
        from qasr.models.qlstm import QLSTMEncoder

        # op_variant for the qlstm arch selects the gate-projection paths:
        #   auto/fast8_recurrent -> rank-8 recurrent (half the weight bytes
        #     re-read every scan step), input projection by M = B*T
        #   fast8 -> rank-8 pre-scan input GEMM only, block recurrent (A/B)
        #   block -> expanded block GEMM everywhere (reference strategy)
        # The default was chosen on the previous accelerator; a hypothesis
        # on the GPU until the benchmark measures it.
        if m.op_variant not in ("auto", "block", "fast8", "fast8_recurrent"):
            raise ValueError(
                f"op_variant {m.op_variant!r} is not valid for arch='qlstm' "
                "(choose auto | block | fast8 | fast8_recurrent)"
            )
        if m.op_variant in ("block", "fast8"):
            input_proj, recurrent = m.op_variant, "block"
        else:
            input_proj, recurrent = "auto", "fast8"
        return QLSTMEncoder(
            conv_features=tuple(m.conv_features),
            dense_features=tuple(m.dense_features),
            lstm_features=m.lstm_features,
            lstm_layers=m.lstm_layers,
            bidirectional=m.bidirectional,
            vocab=m.vocab,
            pool_after=m.pool_after,
            pool_size=m.pool_size,
            dropout_rate=m.dropout_rate,
            dtype=dtype,
            input_proj=input_proj,
            recurrent=recurrent,
        )
    if m.arch == "real_lstm":
        from qasr.models.qlstm import RealLSTMEncoder

        return RealLSTMEncoder(
            conv_features=tuple(m.conv_features),
            dense_features=tuple(m.dense_features),
            lstm_features=m.lstm_features,
            lstm_layers=m.lstm_layers,
            bidirectional=m.bidirectional,
            vocab=m.vocab,
            pool_after=m.pool_after,
            pool_size=m.pool_size,
            dropout_rate=m.dropout_rate,
            dtype=dtype,
        )
    raise ValueError(f"unknown arch {m.arch!r}")


def build_optimizer(cfg: Config) -> optax.GradientTransformation:
    t = cfg.train
    schedule = optax.warmup_cosine_decay_schedule(
        init_value=0.0,
        peak_value=t.learning_rate,
        warmup_steps=t.warmup_steps,
        decay_steps=max(t.num_steps, t.warmup_steps + 1),
        end_value=t.learning_rate * 0.05,
    )
    return optax.chain(
        optax.clip_by_global_norm(t.grad_clip),
        optax.adamw(schedule, weight_decay=t.weight_decay),
    )


def create_train_state(cfg: Config, rng: jax.Array, sample_features) -> TrainState:
    model = build_model(cfg)
    p_rng, d_rng = jax.random.split(rng)
    params = model.init(p_rng, jnp.asarray(sample_features), train=False)["params"]
    tx = build_optimizer(cfg)
    return TrainState(
        step=jnp.zeros((), jnp.int32),
        params=params,
        opt_state=tx.init(params),
        dropout_rng=d_rng,
    )


def param_count(params) -> int:
    return sum(x.size for x in jax.tree_util.tree_leaves(params))
