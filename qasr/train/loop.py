"""Training driver: the L5 experiment loop (SURVEY.md §2a C11, §3.1).

Epoch-less step loop over bucketed batches with periodic eval (greedy dev
PER), checkpointing, and structured metrics incl. audio-seconds/s/chip.

Always SPMD: the loop builds the (data, model) mesh from MeshConfig — a
single chip is just the 1x1 mesh — so 1 chip, 1 host, and N hosts differ only
in mesh construction (SURVEY.md §4 test 6, §5 "Distributed communication
backend"). Batches are placed by the step's in_shardings; PER counters
aggregate across hosts via collectives.
"""

from __future__ import annotations

import time

import jax
import numpy as np

from qasr.configs import Config
from qasr.data.batching import BatchStream, Prefetcher, epoch_iterator
from qasr.data.synthetic import SyntheticDataset
from qasr.decode.scoring import batch_per
from qasr.train.checkpoint import CheckpointManager
from qasr.train.metrics import MetricWriter
from qasr.train.state import param_count


def build_dataset(cfg: Config, *, seed: int = 0, split: str = "train"):
    d = cfg.data
    if d.dataset == "synthetic":
        return SyntheticDataset(
            vocab=cfg.model.vocab,
            n_mels=d.n_mels,
            num_examples=d.num_synthetic,
            seed=seed,
        )
    if d.dataset == "timit":
        from qasr.data.pipeline import TimitFeaturePipeline

        return TimitFeaturePipeline(cfg, split=split)
    if d.dataset == "librispeech":
        from qasr.data.pipeline import LibriFeaturePipeline

        libri_split = split if split != "train" else "train-clean-100"
        return LibriFeaturePipeline(cfg, split=libri_split)
    raise ValueError(f"unsupported dataset {d.dataset!r} in this environment")


def _check_labels(batch, vocab: int) -> None:
    """Host-side guard: a label id >= vocab silently corrupts the CTC lattice
    (it one-hots to an all-zero row, i.e. a free probability-1 emission, so
    the 'NLL' can go negative and the symbol can never be decoded). Fail
    loudly at the source instead."""
    mx = int(np.max(batch["labels"], initial=0))
    if mx >= vocab:
        raise ValueError(
            f"label id {mx} out of range for model.vocab={vocab}; the corpus "
            "symbol inventory and the model vocabulary disagree"
        )


def build_mesh_from_config(cfg: Config):
    # deferred import: qasr.parallel.train imports back into qasr.train
    from qasr.parallel.mesh import make_mesh

    m = cfg.mesh
    n = jax.device_count()
    n_model = min(m.model_axis, n)
    while n % n_model:
        n_model -= 1
    if m.data_axis == -1:
        return make_mesh(n // n_model, n_model)
    # explicit DP extent: take exactly data_axis * model_axis devices (a
    # subset of the slice is a deliberate choice; overshooting is an error)
    want = m.data_axis * n_model
    if want > n:
        raise ValueError(
            f"mesh {m.data_axis}x{n_model} needs {want} devices, have {n}"
        )
    return make_mesh(m.data_axis, n_model, devices=jax.devices()[:want])




def train(cfg: Config, *, metrics_dir: str | None = None, resume: bool = False):
    """Run training to cfg.train.num_steps. Returns (state, last_metrics)."""
    if cfg.train.debug_nans:
        from qasr.utils.debug import nan_debug

        with nan_debug():
            return _train(cfg, metrics_dir=metrics_dir, resume=resume)
    return _train(cfg, metrics_dir=metrics_dir, resume=resume)


def _train(cfg: Config, *, metrics_dir: str | None = None, resume: bool = False):
    from qasr.parallel.train import (
        create_sharded_train_state,
        make_sharded_eval_step,
        make_sharded_train_step,
    )

    rng = jax.random.PRNGKey(cfg.train.seed)
    mesh = build_mesh_from_config(cfg)
    dataset = build_dataset(cfg, seed=cfg.train.seed)
    # model selection runs on the dev split where the corpus defines one
    # (TIMIT protocol, SURVEY.md §2a C9); synthetic falls back to train data
    try:
        eval_dataset = (
            build_dataset(cfg, split="dev")
            if cfg.data.dataset == "timit"
            else build_dataset(cfg, split="dev-clean")
            if cfg.data.dataset == "librispeech"
            else dataset
        )
    except FileNotFoundError:
        eval_dataset = dataset
    stream = BatchStream(dataset, cfg.data, seed=cfg.train.seed)
    first = next(stream)
    _check_labels(first, cfg.model.vocab)

    state, shardings = create_sharded_train_state(cfg, rng, first["features"], mesh)
    ckpt = CheckpointManager(cfg)
    if resume and ckpt.latest_step() is not None:
        last = ckpt.latest_step()
        state = ckpt.restore(last, state)
        data_state = ckpt.restore_data_state(last)
        if data_state is not None:
            stream.restore(data_state)
            first = next(stream)
        print(f"[qasr] resumed from step {int(state.step)}")

    train_step = make_sharded_train_step(cfg, mesh, shardings, first)
    eval_step = make_sharded_eval_step(cfg, mesh, shardings, first)
    writer = MetricWriter(metrics_dir or cfg.train.checkpoint_dir)
    n_chips = jax.device_count()
    frame_s = 0.010  # hop 10 ms -> 1 frame = 10 ms of audio

    print(
        f"[qasr] config={cfg.name} params={param_count(state.params):,} "
        f"mesh={dict(mesh.shape)} devices={n_chips}"
    )
    # one-time per-device memory accounting: proof the TP sharding divides
    # state bytes as configured (max==min under pure DP; max ~ total/model
    # axis under TP), plus allocator stats where the backend reports them
    from qasr.train.metrics import device_memory_stats, per_device_bytes

    pdb = per_device_bytes((state.params, state.opt_state))
    if pdb:
        row = {
            "state_bytes_per_device_max": max(pdb.values()),
            "state_bytes_per_device_min": min(pdb.values()),
        }
        mem = device_memory_stats()
        if mem:
            row["hbm_bytes_in_use_max"] = max(
                v["bytes_in_use"] for v in mem.values()
            )
        writer.write(int(state.step), row)

    # Background prefetch from here on: host batch prep overlaps device
    # compute, and nothing inside the hot loop forces a device fetch (frames
    # are counted from the host-side batch; loss/grad-norm are only pulled at
    # log boundaries), so steps pipeline on the dispatch queue.
    prefetch = Prefetcher(stream, depth=cfg.data.prefetch_depth)
    batch, batch_state = first, stream.state()
    last_metrics = {}
    t_window = time.perf_counter()
    frames_window = 0
    start_step = int(state.step)
    try:
        for step in range(start_step, cfg.train.num_steps):
            state, m = train_step(state, batch)
            frames_window += int(np.sum(batch["feature_lengths"]))
            if (step + 1) % cfg.train.log_every == 0:
                now = time.perf_counter()
                audio_s_per_s = frames_window * frame_s / max(now - t_window, 1e-9)
                last_metrics = {
                    "loss": float(m["loss"]),
                    "grad_norm": float(m["grad_norm"]),
                    "audio_s_per_s_per_chip": audio_s_per_s / n_chips,
                }
                writer.write(step + 1, last_metrics)
                t_window, frames_window = now, 0
            if (step + 1) % cfg.train.eval_every == 0:
                dev = evaluate(cfg, state.params, eval_dataset, eval_step)
                writer.write(step + 1, {"dev_" + k: v for k, v in dev.items()})
                ckpt.save(step + 1, state, dev_per=dev.get("per"), data_state=batch_state)
            elif (step + 1) % cfg.train.checkpoint_every == 0:
                ckpt.save(step + 1, state, data_state=batch_state)
            batch, batch_state = next(prefetch)
            _check_labels(batch, cfg.model.vocab)
    finally:
        prefetch.close()

    ckpt.wait()
    writer.close()
    return state, last_metrics


def evaluate(
    cfg: Config,
    params,
    dataset,
    eval_step,
    *,
    beam: bool = False,
    beam_step=None,
) -> dict:
    """PER over one pass of the dataset: greedy (dev protocol) or prefix
    beam search (final numbers; SURVEY.md §3.4). Counters aggregate across
    hosts (multi-host DP decode).

    Beam eval runs ONE forward per batch (loss + beam decode in a single
    jitted step — no duplicated greedy pass). Pass ``beam_step`` to use a
    prebuilt step; on a multi-host mesh this MUST be
    qasr.parallel.make_sharded_beam_decode_step(cfg, mesh, shardings, batch)
    so per-host batches carry real shardings. When omitted, the single-
    process make_beam_eval_step(cfg) is used — it is lru_cached on the
    config, so repeated calls share one compilation.
    """
    from qasr.parallel.collectives import aggregate_per

    if beam_step is not None:
        beam = True
    elif beam:
        from qasr.train.step import make_beam_eval_step

        if jax.process_count() > 1:
            raise ValueError(
                "evaluate(beam=True) on a multi-host mesh requires an explicit "
                "beam_step from qasr.parallel.make_sharded_beam_decode_step"
            )
        beam_step = make_beam_eval_step(cfg)
    step_fn = beam_step if beam else eval_step

    from qasr.parallel.train import host_rows

    errs = total = 0
    losses = []
    for batch in epoch_iterator(dataset, cfg.data, train=False):
        _check_labels(batch, cfg.model.vocab)
        out = step_fn(params, batch)
        # weight each batch's mean loss by its scored reference tokens so the
        # epoch loss stays an honest per-token average if batch content varies
        # (pad rows of remainder batches carry zero weight — loss_fn already
        # excludes them, so weight by REAL tokens only). Batches from sources
        # other than make_batch may omit the mask: treat every row as real,
        # matching make_loss_fn's optional handling.
        bsz = len(batch["label_lengths"])
        real = np.asarray(batch.get("real_rows", np.ones(bsz, bool)))
        losses.append(
            (float(out["loss"]), int(np.sum(batch["label_lengths"] * real)))
        )
        # multi-host: sharded steps return host-local decoded rows; score them
        # against the same host's slice of the (host-replicated) references.
        # Remainder-batch pad rows (real_rows=False) are dropped so each
        # utterance is scored exactly once (reference protocol).
        refs = host_rows(
            {
                "labels": batch["labels"],
                "label_lengths": batch["label_lengths"],
                "real_rows": batch.get("real_rows", np.ones(bsz, bool)),
            }
        )
        keep = np.asarray(refs["real_rows"])
        if not keep.any():  # this host's slice can be all pads on multi-host
            continue
        e, n = batch_per(
            np.asarray(refs["labels"])[keep],
            np.asarray(refs["label_lengths"])[keep],
            np.asarray(out["decoded"])[keep],
            np.asarray(out["decoded_lengths"])[keep],
            fold=cfg.data.dataset == "timit",
        )
        errs += e
        total += n
    errs, total = aggregate_per(errs, total)
    wsum = sum(w for _, w in losses)
    return {
        "loss": (
            sum(l * w for l, w in losses) / wsum if wsum else float("nan")
        ),
        "per": errs / max(total, 1),
    }
