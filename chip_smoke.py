#!/usr/bin/env python
"""Start-up proof on the GPU: qasr's main path on one card at full preset
widths, checked against the repo's plain references.

    python chip_smoke.py               # one card
    python chip_smoke.py --four-cards  # only the multi-card path, on four

One card, in one process:

1. parity of every conv/dense/recurrence path the ``auto`` routing reaches,
   at real widths, against the 16-product float32 oracles run at HIGHEST
   matmul precision (so the reference itself never drops to TF32);
2. ``timit_qcnn`` (QCNN-256) trained through ``qasr.cli`` on a mini-TIMIT
   corpus generated from a seed (RIFF read, on-device log-mel + deltas,
   CTC), checkpointed, resumed, and the checkpoint round-tripped bit for bit;
3. ``--eval-only --beam`` on that checkpoint, and the W=100 device beam
   compared hypothesis for hypothesis with the C++ host decoder, in float64
   (where the two are the same search) and in float32;
4. ``qasr.infer.Transcriber`` on generated wavs;
5. ``librispeech_qlstm`` trained through ``qasr.cli`` on a mini-LibriSpeech
   corpus.

``--four-cards`` runs ``librispeech_large`` at preset widths (T cut to 512,
batch to 16, float32) on a 1x4 DPxTP and a 4x1 DP mesh against the same
step on one card, the sharded beam step against the unsharded one, and the
sequence-parallel conv and CTC against the unsharded ops.

Weights are random, made from fixed seeds. Every phase raises on failure.
The last line of stdout is one JSON object, printed only when every phase
passed. Without a GPU the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import runpy
import shutil
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
WORK = REPO / ".smoke_work"  # generated corpora and checkpoints (.gitignore)

# --- full sizes (tests run the same phases at tiny sizes) -------------------
PARITY = dict(b=16, t=256, f_in=40, f=13, c=256, dense_m=4096, lstm_b=8,
              lstm_t=512, lstm_h=256, lstm_cin=13 * 128, dtype="bfloat16")
TIMIT_CORPUS = dict(train_speakers=4, utts_per_speaker=8, dev_speakers=2,
                    test_speakers=2)
LIBRI_CORPUS = dict(speakers=4, utts_per_speaker=8, dev_speakers=1)
FOUR_CARD = dict(t=512, b=16, seq_b=4, seq_t=2048, seq_f=13, seq_c=256)


def log(msg: str) -> None:
    print(msg, flush=True)


@contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    log(f"== {name}")
    yield
    log(f"== {name}: ok ({time.perf_counter() - t0:.1f} s)")


def rel_rms(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.sqrt(np.mean((got - want) ** 2) / max(np.mean(want**2), 1e-300)))


def check(name: str, got, want, tol: float, why: str) -> float:
    r = rel_rms(got, want)
    log(f"parity {name}: rel_rms={r:.3e} tol={tol:.2g} ({why})")
    if not r < tol:
        raise AssertionError(f"{name}: relative RMS {r:.3e} >= {tol:.2g}")
    return r


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def run_tool(script: str, **flags) -> None:
    """Run one of tools/*.py in this process, as its command line would."""
    argv = [script] + [f"--{k.replace('_', '-')}={v}" for k, v in flags.items()]
    saved = sys.argv
    sys.argv = argv
    try:
        runpy.run_path(str(REPO / "tools" / script), run_name="__main__")
    finally:
        sys.argv = saved


def print_memory(name: str, compiled) -> None:
    m = compiled.memory_analysis()
    gib = 1 << 30
    log(
        f"memory {name}: args={m.argument_size_in_bytes / gib:.3f} GiB "
        f"outputs={m.output_size_in_bytes / gib:.3f} GiB "
        f"temps={m.temp_size_in_bytes / gib:.3f} GiB "
        f"aliased={m.alias_size_in_bytes / gib:.3f} GiB "
        f"code={m.generated_code_size_in_bytes / gib:.4f} GiB"
    )


# --- 1. parity ---------------------------------------------------------------

# Tolerances are relative RMS of the whole output against the float32
# oracle. A wrong tap, a dropped product or a sign error lands near 1, so
# each bound sits orders of magnitude below a real fault.
TOL_BF16 = 2e-2  # bf16 operands and output (8-bit mantissa, ~0.3% each),
# f32 accumulation: the reduced-product combos add one bf16 rounding more
TOL_F32_HIGHEST = 1e-4  # same arithmetic in f32 at HIGHEST: summation order
TOL_TF32 = 1e-2  # f32 at default precision: TF32 keeps 10 mantissa bits
TOL_LSTM_BF16 = 2.5e-2  # bf16 gates and state compound rounding over T
# steps: at most 1.39e-2 on the H100 with the recurrent-weight gradient summed
# in f32, and 4.24e-2 / 4.76e-2 (fwd/bwd d wh) when it was summed in bf16


def parity_phase(s: dict) -> None:
    import jax
    import jax.numpy as jnp

    from qasr.models.qlstm import QBiLSTM, qbilstm_reference
    from qasr.ops.qlinalg import (
        pack_to_stacked,
        qconv,
        qconv_expanded_oracle,
        qconv_fast10,
        qconv_fast8_stacked,
        qdense,
        stacked_to_pack,
    )
    from qasr.ops.quaternion import qdense_naive

    bf, f32 = jnp.dtype(s["dtype"]), jnp.float32
    hi = jax.default_matmul_precision("highest")
    rng = np.random.RandomState(0)

    def rnd(shape, scale=1.0, dtype=bf):
        # drawn on the host in f32 and rounded once to the compute dtype;
        # oracles get the rounded values, so only the path's own arithmetic
        # differs
        a = rng.standard_normal(shape).astype(np.float32) * np.float32(scale)
        return jnp.asarray(a.astype(dtype))

    up = jax.jit(lambda a: a.astype(f32))

    def oracle(x, w):
        with hi:
            return jax.jit(qconv_expanded_oracle)(up(x), up(w))

    def fwd_bwd(fn):
        """(y, dx, dw) of fn(x, w) for the cotangent g, as one program."""
        def run(x, w, g):
            y, vjp = jax.vjp(fn, x, w)
            return (y, *vjp(g))
        return jax.jit(run)

    to_stacked = jax.jit(lambda a: pack_to_stacked(jnp.swapaxes(a, 1, 2)))
    to_packed = jax.jit(lambda a: jnp.swapaxes(stacked_to_pack(a), 1, 2))

    b, t, c = s["b"], s["t"], s["c"]
    # block conv, the input layer: 1 quaternion channel -> c
    x = rnd((b, t, s["f_in"], 4))
    w = rnd((4, 3, 3, 1, c), 0.3)
    check(f"block conv 1->{c}", jax.jit(qconv)(x, w), oracle(x, w), TOL_BF16,
          "bf16 operands/output")

    # packed 10-product conv, c -> c
    x = rnd((b, t, s["f"], 4 * c), 0.5)
    w = rnd((4, 3, 3, c, c), 0.03)
    check(f"fast10 conv {c}->{c}", jax.jit(qconv_fast10)(x, w), oracle(x, w),
          TOL_BF16, "bf16 operands/output + bf16 combos")

    # stacked rank-8 conv: forward, dx and dW against the oracle's VJP
    g = rnd(x.shape[:-1] + (4 * c,))
    y, dx, dw = fwd_bwd(qconv_fast8_stacked)(to_stacked(x), w, to_stacked(g))
    with hi:
        y_ref, dx_ref, dw_ref = fwd_bwd(qconv_expanded_oracle)(up(x), up(w), up(g))
    check(f"fast8 stacked conv {c}->{c} fwd", to_packed(y), y_ref, TOL_BF16,
          "bf16 operands/output + bf16 combos")
    check(f"fast8 stacked conv {c}->{c} dx", to_packed(dx), dx_ref, TOL_BF16,
          "bf16 cotangent/output + bf16 combos")
    check(f"fast8 stacked conv {c}->{c} dW", dw, dw_ref, TOL_BF16,
          "bf16 operands, f32 reduction over B*F*T")

    # block dense at the first dense layer's shape: K = F * c
    k = s["f"] * c
    x = rnd((s["dense_m"], 4 * k), 0.5)
    w = rnd((4, k, c), 0.02)
    with hi:
        want = jax.jit(qdense_naive)(up(x), up(w))
    check(f"block dense M{s['dense_m']} K{k} N{c}", jax.jit(qdense)(x, w), want,
          TOL_BF16, "bf16 operands/output")

    # the rank-8 fused QBiLSTM recurrence, forward and every gradient,
    # against the step-by-step f32 reference; once in bf16 (the production
    # dtype) and once in f32 at HIGHEST (same code, exact arithmetic)
    lb, lt, lh, cin = s["lstm_b"], s["lstm_t"], s["lstm_h"], s["lstm_cin"]
    x = rnd((lb, lt, 4 * cin), 0.5, f32)
    lengths = jnp.asarray(np.linspace(lt, lt // 2, lb).astype(np.int32))
    cot = rnd((lb, lt, 8 * lh), 1.0, f32)
    params = jax.jit(lambda k: QBiLSTM(lh).init(k, x, lengths))(
        jax.random.PRNGKey(0))["params"]

    def loss_ref(p, xx):
        return jnp.sum(qbilstm_reference(p, xx, lengths) * cot)

    y_ref, g_ref = jax.jit(
        lambda p, xx: (qbilstm_reference(p, xx, lengths),
                       jax.grad(loss_ref, argnums=(0, 1))(p, xx))
    )(params, x)
    for dtype, tol, why, ctx in (
        (bf, TOL_LSTM_BF16, "bf16 gates/state over T steps", None),
        (f32, TOL_F32_HIGHEST, "f32 at HIGHEST", hi),
    ):
        m = QBiLSTM(lh, recurrent="fast8", input_proj="auto", dtype=dtype)

        def loss(p, xx, m=m):
            y = m.apply({"params": p}, xx, lengths).astype(f32)
            return jnp.sum(y * cot)

        fn = jax.jit(lambda p, xx, m=m, loss=loss: (
            m.apply({"params": p}, xx, lengths),
            jax.grad(loss, argnums=(0, 1))(p, xx)))
        if ctx is not None:
            with ctx:
                y, g = fn(params, x)
        else:
            y, g = fn(params, x)
        name = f"qbilstm rank-8 {jnp.dtype(dtype).name} B{lb} T{lt} H{lh}"
        check(f"{name} fwd", y, y_ref, tol, why)
        check(f"{name} dx", g[1], g_ref[1], tol, why)
        for (path, a), b_ in zip(
            jax.tree_util.tree_leaves_with_path(g_ref[0]), jax.tree_util.tree_leaves(g[0])
        ):
            check(f"{name} d{jax.tree_util.keystr(path)}", b_, a, tol, why)

    # tiny_synthetic computes in f32 at default precision, i.e. TF32 convs
    # on this card: report how far that lands from the HIGHEST oracle
    x = rnd((8, 64, 8, 4), 1.0, f32)
    w = rnd((4, 3, 3, 1, 8), 0.3, f32)
    check("tiny_synthetic f32 default-precision conv 1->8",
          jax.jit(qconv)(x, w), oracle(x, w), TOL_TF32, "TF32 vs f32 HIGHEST")
    x = rnd((8, 64, 2, 32), 1.0, f32)
    w = rnd((4, 3, 3, 8, 8), 0.3, f32)
    check("tiny_synthetic f32 default-precision conv 8->8",
          jax.jit(qconv)(x, w), oracle(x, w), TOL_TF32, "TF32 vs f32 HIGHEST")


# --- 2-5. the main path through the CLI -------------------------------------

def cli(*argv: str) -> None:
    from qasr.cli import main as cli_main

    log("$ qasr-train " + " ".join(argv))
    cli_main(list(argv))


def read_losses(ckpt_dir: Path) -> dict[int, float]:
    out = {}
    with open(ckpt_dir / "metrics.jsonl") as f:
        for line in f:
            rec = json.loads(line)
            if "loss" in rec:
                out[rec["step"]] = rec["loss"]
    return out


def step_memory(cfg) -> None:
    """memory_analysis() of the train step the trainer compiles first: the
    same mesh, state and first batch (lowered ahead of time; the trainer's
    own compile of that program then comes from the compile cache)."""
    import jax

    from qasr.data.batching import BatchStream
    from qasr.parallel import create_sharded_train_state, make_sharded_train_step
    from qasr.train.loop import build_dataset, build_mesh_from_config

    batch = next(BatchStream(build_dataset(cfg, seed=cfg.train.seed), cfg.data,
                             seed=cfg.train.seed))
    mesh = build_mesh_from_config(cfg)
    state, shardings = create_sharded_train_state(
        cfg, jax.random.PRNGKey(cfg.train.seed), batch["features"], mesh
    )
    step = make_sharded_train_step(cfg, mesh, shardings, batch)
    b, t = batch["features"].shape[:2]
    print_memory(f"{cfg.name} train step B{b} T{t}", step.lower(state, batch).compile())


def beam_parity(name, logits, lengths, real_rows, kw, *, f32_exact: bool) -> None:
    """The device prefix beam against the C++ host beam on the same logits,
    hypothesis for hypothesis, for every real row.

    In float64 the two decoders are the same search and must agree on every
    row. In float32, on the flat logits of an untrained model, prefixes sit
    within float32 rounding of each other at the beam's edge, and a tie that
    rounds one way in one decoder and the other way in the other sends the
    two searches apart; the float32 rows that differ are printed, and
    ``f32_exact`` demands that none do (for logits with clear winners).
    """
    import jax
    import jax.numpy as jnp

    from qasr.decode.beam import ctc_beam_search_decode
    from qasr.native import ctc_beam_decode_native

    real = np.flatnonzero(real_rows)
    lengths = np.asarray(lengths, np.int32)
    differ = {}
    for dtype in (np.float64, np.float32):
        x = np.asarray(logits, np.float32).astype(dtype)
        with jax.enable_x64(dtype == np.float64):
            d_seq, d_len, d_score = (np.asarray(a) for a in ctc_beam_search_decode(
                jnp.asarray(x), jnp.asarray(lengths), **kw))
        n_seq, n_len, n_score = ctc_beam_decode_native(x, lengths, **kw)
        differ[dtype] = [
            i for i in real
            if d_len[i] != n_len[i]
            or not np.array_equal(d_seq[i, : d_len[i]], n_seq[i, : n_len[i]])
        ]
        log(f"beam W={kw['beam_width']} on {name} in {np.dtype(dtype).name}: device == "
            f"C++ host on {len(real) - len(differ[dtype])}/{len(real)} hypotheses; "
            f"lengths {d_len[real].tolist()}")
        for i in differ[dtype]:
            log(f"  row {i} differs: device {d_len[i]} symbols, log-score "
                f"{d_score[i]:.6f}; C++ {n_len[i]} symbols, log-score {n_score[i]:.6f}")
    if differ[np.float64]:
        raise AssertionError(f"device beam and C++ beam disagree on {name} in float64")
    if f32_exact and differ[np.float32]:
        raise AssertionError(f"device beam and C++ beam disagree on {name} in float32")


def timit_phases(work: Path, *, preset: str = "timit_qcnn", extra: tuple = (),
                 corpus: dict = TIMIT_CORPUS, steps: int = 4) -> None:
    import jax
    import jax.numpy as jnp

    from qasr.configs import get_config
    from qasr.data.batching import epoch_iterator
    from qasr.train.checkpoint import CheckpointManager
    from qasr.train.loop import build_dataset
    from qasr.train.state import build_model

    data, ckpt = work / "mini_timit", work / "ckpt_timit"
    sets = [f"data.data_dir={data}", f"train.checkpoint_dir={ckpt}",
            "train.checkpoint_every=2", "train.eval_every=100000",
            "train.log_every=1", *extra]

    with phase(f"{preset}: corpus"):
        run_tool("make_mini_timit.py", out=data, seed=0, **corpus)

    cfg = get_config(preset).override(**dict(kv.split("=", 1) for kv in sets))
    with phase(f"{preset}: train {steps} steps, checkpoint, resume +2"):
        step_memory(cfg)
        cli("--preset", preset, "--set", *sets, f"train.num_steps={steps}")
        cli("--preset", preset, "--set", *sets, f"train.num_steps={steps + 2}",
            "--resume")
        losses = read_losses(ckpt)
        log(f"losses {preset}: {losses}")
        want = set(range(1, steps + 3))
        if set(losses) != want:
            raise AssertionError(f"logged steps {sorted(losses)} != {sorted(want)}")
        if not all(np.isfinite(v) for v in losses.values()):
            raise AssertionError(f"non-finite loss in {losses}")
        log(f"losses finite: {len(losses)} steps")
        mgr = CheckpointManager(cfg, write_config=False)
        last = mgr.latest_step()
        if last != steps + 2:
            raise AssertionError(f"latest checkpoint {last}, want {steps + 2}")

    with phase(f"{preset}: checkpoint round trip"):
        from qasr.parallel import create_sharded_train_state
        from qasr.train.loop import build_mesh_from_config

        ds = build_dataset(cfg, split="dev")
        batch = next(iter(epoch_iterator(ds, cfg.data, train=False)))
        target, _ = create_sharded_train_state(
            cfg, jax.random.PRNGKey(1), batch["features"], build_mesh_from_config(cfg)
        )
        state = mgr.restore(last, target)
        copy_cfg = cfg.override(**{"train.checkpoint_dir": str(work / "ckpt_copy")})
        CheckpointManager(copy_cfg).save(last, state)
        a = np.load(ckpt / str(last) / "state.npz")
        b = np.load(work / "ckpt_copy" / str(last) / "state.npz")
        if sorted(a.files) != sorted(b.files):
            raise AssertionError("round trip changed the set of arrays")
        bad = [k for k in a.files if not np.array_equal(a[k], b[k])]
        if bad:
            raise AssertionError(f"round trip not bit-equal: {bad[:5]}")
        log(f"checkpoint round trip bit-equal: {len(a.files)} arrays, step {last}")

    with phase(f"{preset}: eval-only beam W={cfg.decode.beam_width}"):
        cli("--preset", preset, "--set", *sets, "--eval-only", "--beam")
        params = mgr.restore_params(last, cfg, batch["features"])
        model = build_model(cfg)
        logits = jax.jit(
            lambda p, x, n: model.apply({"params": p}, x, train=False, lengths=n)
        )(params, jnp.asarray(batch["features"]), jnp.asarray(batch["feature_lengths"]))
        kw = dict(beam_width=cfg.decode.beam_width, blank_id=cfg.decode.blank_id,
                  max_len=cfg.data.max_label_len, prune_logp=cfg.decode.beam_prune_logp)
        beam_parity("checkpoint logits", logits, batch["feature_lengths"],
                    batch["real_rows"], kw, f32_exact=False)
        # the test suite's protocol-width logits (tests/test_beam.py)
        v = cfg.model.vocab
        logits = jax.random.normal(jax.random.PRNGKey(17), (3, 80, v)) * 2.0
        beam_parity("random logits", logits, np.asarray([80, 73, 40], np.int32),
                    np.ones(3, bool), dict(kw, max_len=60, prune_logp=None),
                    f32_exact=True)

    with phase(f"{preset}: Transcriber"):
        from qasr.infer import Transcriber

        tr = Transcriber(str(ckpt))
        wavs = sorted((data / "test").rglob("*.wav"))[:3]
        for path in wavs:
            phones = tr.transcribe_file(str(path))
            if not all(isinstance(p, str) for p in phones):
                raise AssertionError(f"{path}: {phones!r}")
            log(f"transcribe {path.name}: {len(phones)} phones")


def libri_phases(work: Path, *, preset: str = "librispeech_qlstm", extra: tuple = (),
                 corpus: dict = LIBRI_CORPUS, steps: int = 3) -> None:
    from qasr.configs import get_config

    data, ckpt = work / "mini_libri", work / "ckpt_libri"
    sets = [f"data.data_dir={data}", f"train.checkpoint_dir={ckpt}",
            "train.checkpoint_every=100000", "train.eval_every=100000",
            "train.log_every=1", f"train.num_steps={steps}", *extra]
    with phase(f"{preset}: corpus"):
        run_tool("make_mini_librispeech.py", out=data, seed=0, **corpus)
    cfg = get_config(preset).override(**dict(kv.split("=", 1) for kv in sets))
    with phase(f"{preset}: train {steps} steps"):
        step_memory(cfg)
        cli("--preset", preset, "--set", *sets)
        losses = read_losses(ckpt)
        log(f"losses {preset}: {losses}")
        if sorted(losses) != list(range(1, steps + 1)) or not all(
            np.isfinite(v) for v in losses.values()
        ):
            raise AssertionError(f"bad losses {losses}")
        log(f"losses finite: {len(losses)} steps")


# --- four cards ---------------------------------------------------------------

# The mesh comparisons run in float32 at HIGHEST precision, so the sharded
# and the one-card program differ only in the order their reductions sum.
TOL_MESH_LOSS = 1e-4  # loss and gradient norm, relative
TOL_MESH_PARAMS = 1e-3  # updated params, relative RMS over all of them:
# Adam's first step moves every weight by ~lr whatever the gradient's size,
# so a weight whose gradient is ~0 can move either way in the two programs


def four_card_phase(devices, s: dict, *, extra: tuple = ()) -> None:
    import jax
    import jax.numpy as jnp

    from qasr.configs import get_config
    from qasr.data import SyntheticDataset, epoch_iterator
    from qasr.ops.ctc import ctc_loss
    from qasr.ops.qlinalg import qconv_expanded_oracle
    from qasr.parallel import (
        create_sharded_train_state,
        make_mesh,
        make_sharded_beam_decode_step,
        make_sharded_train_step,
    )
    from qasr.parallel.seq_parallel import ctc_loss_seq_parallel, qconv2d_seq_parallel
    from qasr.train.step import make_beam_eval_step

    t, b = s["t"], s["b"]
    base = get_config("librispeech_large")
    log(f"librispeech_large: widths as preset (conv {base.model.conv_features}, "
        f"dense {base.model.dense_features}); T cut from buckets "
        f"{base.data.bucket_sizes} to ({t},), batch from {base.data.batch_size} to "
        f"{b}; float32 at HIGHEST (preset: {base.model.compute_dtype}); no LR warmup")
    overrides = {"data.bucket_sizes": f"({t},)", "data.batch_size": b,
                 "model.compute_dtype": "float32", "train.warmup_steps": 0}
    overrides.update(dict(kv.split("=", 1) for kv in extra))
    cfg = base.override(**overrides)
    # utterances of t/16..t/8 labels at 3..8 frames each fill the one bucket
    ds = SyntheticDataset(vocab=cfg.model.vocab, n_mels=cfg.data.n_mels,
                          num_examples=cfg.data.batch_size, seed=0,
                          min_labels=t // 16, max_labels=t // 8, max_dur=8)
    batch = next(iter(epoch_iterator(ds, cfg.data, train=False)))
    if batch["features"].shape[1] != t:
        raise AssertionError(f"batch bucket {batch['features'].shape}, want T={t}")
    hi = jax.default_matmul_precision("highest")

    def flat(tree):
        return np.concatenate([np.asarray(a, np.float64).ravel()
                               for a in jax.tree_util.tree_leaves(tree)])

    with hi:
        one = make_mesh(1, 1, devices=devices[:1])
        state1, sh1 = create_sharded_train_state(cfg, jax.random.PRNGKey(0),
                                                 batch["features"], one)
        init = jax.tree.map(np.asarray, state1)  # host copy: the steps donate
        step1 = make_sharded_train_step(cfg, one, sh1, batch).lower(state1, batch).compile()
        print_memory("librispeech_large step, 1 card", step1)
        new1, m1 = step1(state1, batch)
    ref_params = flat(new1.params)
    ref_loss, ref_gn = float(m1["loss"]), float(m1["grad_norm"])
    log(f"1 card: loss={ref_loss:.6f} grad_norm={ref_gn:.6f}; the step moved "
        f"weights by up to {np.max(np.abs(ref_params - flat(init.params))):.3e}")

    for n_data, n_model in ((1, 4), (4, 1)):
        with phase(f"librispeech_large step on a {n_data}x{n_model} mesh vs 1 card"), hi:
            mesh = make_mesh(n_data, n_model, devices=devices)
            _, sh = create_sharded_train_state(cfg, jax.random.PRNGKey(0),
                                               batch["features"], mesh)
            state = jax.device_put(init, sh)
            step = make_sharded_train_step(cfg, mesh, sh, batch).lower(state, batch).compile()
            print_memory(f"librispeech_large step, {n_data}x{n_model}", step)
            new, m = step(state, batch)
            loss, gn = float(m["loss"]), float(m["grad_norm"])
            log(f"{n_data}x{n_model}: loss={loss:.6f} grad_norm={gn:.6f}")
            for name, got, want in (("loss", loss, ref_loss), ("grad_norm", gn, ref_gn)):
                rel = abs(got - want) / abs(want)
                log(f"parity {n_data}x{n_model} {name}: rel={rel:.3e} tol={TOL_MESH_LOSS:.0e}")
                if not (np.isfinite(got) and rel < TOL_MESH_LOSS):
                    raise AssertionError(f"{name} {got} vs 1 card {want}")
            check(f"{n_data}x{n_model} updated params", flat(new.params), ref_params,
                  TOL_MESH_PARAMS, "f32 HIGHEST, Adam first step")

    with phase("sharded beam step (4x1) vs unsharded beam"), hi:
        # f32 at HIGHEST, so both programs see the same logits to ~1e-6 and
        # no near-tie between prefixes can flip
        mesh = make_mesh(4, 1, devices=devices)
        st, sh = create_sharded_train_state(cfg, jax.random.PRNGKey(0),
                                            batch["features"], mesh)
        got = make_sharded_beam_decode_step(cfg, mesh, sh, batch)(st.params, batch)
        params1 = jax.device_put(jax.tree.map(np.asarray, st.params), devices[0])
        want = make_beam_eval_step(cfg)(params1, batch)
        g_seq, g_len = np.asarray(got["decoded"]), np.asarray(got["decoded_lengths"])
        w_seq, w_len = np.asarray(want["decoded"]), np.asarray(want["decoded_lengths"])
        same = sum(
            g_len[i] == w_len[i] and np.array_equal(g_seq[i, : g_len[i]], w_seq[i, : w_len[i]])
            for i in range(len(g_len))
        )
        log(f"beam W={cfg.decode.beam_width}: sharded == unsharded on "
            f"{same}/{len(g_len)} hypotheses (lengths {w_len.tolist()})")
        if same != len(g_len):
            raise AssertionError("sharded beam disagrees with the unsharded beam")

    with phase("sequence-parallel conv and CTC (time over 4 cards) vs unsharded"), hi:
        sp = make_mesh(4, 1, devices=devices)
        k = jax.random.split(jax.random.PRNGKey(3), 4)
        b, tt, f, c = s["seq_b"], s["seq_t"], s["seq_f"], s["seq_c"]
        x = jax.random.normal(k[0], (b, tt, f, 4 * c), jnp.float32)
        w = jax.random.normal(k[1], (4, 3, 3, c, c), jnp.float32) * 0.03
        got = jax.jit(lambda x, w: qconv2d_seq_parallel(x, w, sp))(x, w)
        want = jax.jit(qconv_expanded_oracle)(x, w)
        check(f"seq-parallel conv {c}->{c} T{tt}", got, want, TOL_F32_HIGHEST,
              "f32 at HIGHEST")
        v = cfg.model.vocab
        logits = jax.random.normal(k[2], (b, tt, v), jnp.float32)
        labels = jax.random.randint(k[3], (b, tt // 16), 1, v)
        tl = jnp.asarray(np.linspace(tt, tt // 2, b).astype(np.int32))
        ll = jnp.asarray(np.full((b,), tt // 16, np.int32))
        got = jax.jit(lambda *a: ctc_loss_seq_parallel(*a, sp))(logits, labels, tl, ll)
        want = jax.jit(ctc_loss)(logits, labels, tl, ll)
        check(f"seq-parallel CTC B{b} T{tt} V{v}", got, want, TOL_F32_HIGHEST,
              "f32 lattice, chunked alpha carried between cards")


# --- main ---------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-card path, on four cards")
    args = ap.parse_args(argv)

    import jax

    if jax.default_backend() != "gpu":
        print(f"chip_smoke: no GPU (JAX backend {jax.default_backend()!r}); "
              "this script only runs on the card", file=sys.stderr)
        return 2
    log(card_line())
    want = 4 if args.four_cards else 1
    devices = jax.devices()
    if len(devices) < want:
        print(f"chip_smoke: need {want} GPUs, JAX sees {len(devices)}", file=sys.stderr)
        return 2
    devices = devices[:want]

    from qasr.utils.compile_cache import enable_compile_cache

    log(f"jax {jax.__version__}; devices {[d.device_kind for d in devices]}; "
        f"compile cache {enable_compile_cache()}")
    t0 = time.perf_counter()
    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir(parents=True)
    if args.four_cards:
        four_card_phase(devices, FOUR_CARD)
    else:
        with phase("parity at real widths"):
            parity_phase(PARITY)
        timit_phases(WORK)
        libri_phases(WORK)
    shutil.rmtree(WORK)
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    d = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
