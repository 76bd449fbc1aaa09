"""End-to-end convergence smoke + checkpoint round-trip (SURVEY.md §4 test 7,
BASELINE.json config 1: CPU-runnable small QCNN + CTC + greedy decode)."""

import os

import jax
import numpy as np
import pytest

from qasr.configs import get_config
from qasr.data import SyntheticDataset, epoch_iterator, make_batch
from qasr.decode.scoring import batch_per, edit_distance
from qasr.train import (
    CheckpointManager,
    create_train_state,
    evaluate,
    make_eval_step,
    make_train_step,
    train,
)


@pytest.fixture(scope="module")
def tiny_cfg(tmp_path_factory):
    ckpt = tmp_path_factory.mktemp("ckpt")
    return get_config("tiny_synthetic").override(
        **{
            "train.num_steps": 220,
            "train.eval_every": 110,
            "train.checkpoint_every": 110,
            "train.log_every": 40,
            "train.checkpoint_dir": str(ckpt),
        }
    )


class TestEditDistance:
    def test_basic(self):
        assert edit_distance([1, 2, 3], [1, 2, 3]) == 0
        assert edit_distance([1, 2, 3], [1, 3]) == 1
        assert edit_distance([], [1, 2]) == 2
        assert edit_distance([1, 2], [2, 1]) == 2
        assert edit_distance("kitten", "sitting") == 3

    def test_batch_per(self):
        refs = np.array([[1, 2, 3, 0], [4, 5, 0, 0]])
        ref_lens = np.array([3, 2])
        hyps = np.array([[1, 2, 3, 0], [4, 6, 0, 0]])
        hyp_lens = np.array([3, 2])
        errs, total = batch_per(refs, ref_lens, hyps, hyp_lens, fold=False)
        assert (errs, total) == (1, 5)


class TestBatching:
    def test_static_shapes(self):
        ds = SyntheticDataset(vocab=12, n_mels=8, num_examples=32, seed=0)
        cfg = get_config("tiny_synthetic").data
        shapes = set()
        count = 0
        for batch in epoch_iterator(ds, cfg, train=True):
            assert batch["features"].shape[0] == cfg.batch_size
            assert batch["features"].shape[1] in cfg.bucket_sizes
            shapes.add(batch["features"].shape)
            count += 1
        assert count >= 2
        assert len(shapes) <= len(cfg.bucket_sizes)

    def test_truncation_clamps_labels_to_ctc_feasible(self):
        """A bucket-truncated utterance must not yield an infeasible (T, L)
        pair: CTC needs L + repeats(labels) <= T or the lattice has zero mass
        and the loss saturates near the log-space floor (~1e30)."""
        import jax.numpy as jnp

        from qasr.ops.ctc import ctc_loss

        rng = np.random.RandomState(0)
        t_bucket, n_labels = 16, 40  # 40 labels cannot fit in 16 frames
        x = rng.randn(100, 8, 4).astype(np.float32)
        y = rng.randint(1, 12, size=(n_labels,))
        y[5] = y[4]  # adjacent repeat: costs one extra frame
        with pytest.warns(UserWarning, match="CTC-feasible"):
            batch = make_batch([(x, y)], t_bucket, 64)
        l = int(batch["label_lengths"][0])
        assert 0 < l < n_labels
        repeats = int(np.sum(batch["labels"][0, 1:l] == batch["labels"][0, : l - 1]))
        assert l + repeats <= t_bucket

        logits = jnp.asarray(rng.randn(1, t_bucket, 13).astype(np.float32))
        loss = ctc_loss(
            logits,
            jnp.asarray(batch["labels"]),
            jnp.asarray(batch["feature_lengths"]),
            jnp.asarray(batch["label_lengths"]),
        )
        assert float(np.max(np.asarray(loss))) < 1e4  # not the 1e30 floor

    def test_feasible_label_len_exact(self):
        from qasr.data.batching import feasible_label_len

        assert feasible_label_len([], 5) == 0
        assert feasible_label_len([1, 2, 3], 3) == 3
        assert feasible_label_len([1, 1, 2], 3) == 2  # repeat needs a blank
        assert feasible_label_len([1, 1, 2], 4) == 3
        assert feasible_label_len([7] * 10, 5) == 3  # 3 emits + 2 blanks

    def test_lengths_consistent(self):
        ds = SyntheticDataset(vocab=12, n_mels=8, num_examples=16, seed=1)
        cfg = get_config("tiny_synthetic").data
        batch = next(iter(epoch_iterator(ds, cfg, train=False)))
        assert (batch["feature_lengths"] > 0).all()
        assert (batch["label_lengths"] > 0).all()
        # padding beyond feature_lengths is zero
        i = 0
        t = int(batch["feature_lengths"][i])
        assert (batch["features"][i, t:] == 0).all()


class TestEvalPadRows:
    """Remainder-batch padding must not double-score utterances (the
    reference protocol scores each utterance exactly once)."""

    def test_remainder_batches_mark_pad_rows(self):
        from qasr.data.batching import _PairView, bucketed_batches

        ds = SyntheticDataset(vocab=12, n_mels=8, num_examples=17, seed=0)
        cfg = get_config("tiny_synthetic").data
        batches = list(
            bucketed_batches(
                _PairView(ds),
                batch_size=16,
                bucket_sizes=cfg.bucket_sizes,
                max_label_len=cfg.max_label_len,
                shuffle=False,
                drop_remainder=False,
            )
        )
        assert all(b["real_rows"].shape[0] == 16 for b in batches)
        assert sum(int(b["real_rows"].sum()) for b in batches) == 17
        # pad rows are a contiguous tail (host_rows slicing relies on this)
        for b in batches:
            r = b["real_rows"]
            assert (np.diff(r.astype(int)) <= 0).all()

    def test_evaluate_scores_each_utterance_once(self, monkeypatch):
        """17-utterance dev set at B=16 -> exactly 17 scored rows, not 32."""
        import qasr.train.loop as loop_mod

        cfg = get_config("tiny_synthetic").override(
            **{"data.batch_size": 16, "data.num_synthetic": 17}
        )
        ds = SyntheticDataset(
            vocab=cfg.model.vocab, n_mels=cfg.data.n_mels,
            num_examples=17, seed=0,
        )
        first = next(iter(epoch_iterator(ds, cfg.data, train=False)))
        state = create_train_state(cfg, jax.random.PRNGKey(0), first["features"])

        scored = []
        real_bp = loop_mod.batch_per

        def counting_bp(refs, ref_lens, hyps, hyp_lens, **kw):
            scored.append(len(ref_lens))
            return real_bp(refs, ref_lens, hyps, hyp_lens, **kw)

        monkeypatch.setattr(loop_mod, "batch_per", counting_bp)
        dev = evaluate(cfg, state.params, ds, make_eval_step(cfg))
        assert sum(scored) == 17
        assert np.isfinite(dev["loss"])

    def test_beam_eval_scores_each_utterance_once(self, monkeypatch):
        """The beam-decode eval path must drop pad rows too."""
        import qasr.train.loop as loop_mod

        cfg = get_config("tiny_synthetic").override(
            **{"data.batch_size": 8, "data.num_synthetic": 11}
        )
        ds = SyntheticDataset(
            vocab=cfg.model.vocab, n_mels=cfg.data.n_mels,
            num_examples=11, seed=0,
        )
        first = next(iter(epoch_iterator(ds, cfg.data, train=False)))
        state = create_train_state(cfg, jax.random.PRNGKey(0), first["features"])

        scored = []
        real_bp = loop_mod.batch_per

        def counting_bp(refs, ref_lens, hyps, hyp_lens, **kw):
            scored.append(len(ref_lens))
            return real_bp(refs, ref_lens, hyps, hyp_lens, **kw)

        monkeypatch.setattr(loop_mod, "batch_per", counting_bp)
        dev = evaluate(cfg, state.params, ds, None, beam=True)
        assert sum(scored) == 11
        assert np.isfinite(dev["loss"])

    def test_masked_loss_ignores_pad_rows(self):
        """The per-token eval loss must be identical whether an utterance
        arrives alone or alongside masked pad repeats."""
        from qasr.data.batching import make_batch
        from qasr.train.step import make_loss_fn
        from qasr.train.state import build_model

        cfg = get_config("tiny_synthetic")
        ds = SyntheticDataset(vocab=12, n_mels=8, num_examples=3, seed=0)
        exs = [(ds[i].features, ds[i].labels) for i in range(3)]
        solo = make_batch(exs, 64, cfg.data.max_label_len)
        padded = make_batch(exs + [exs[0]] * 5, 64, cfg.data.max_label_len,
                            num_real=3)
        model = build_model(cfg)
        params = model.init(
            jax.random.PRNGKey(0),
            jax.numpy.asarray(solo["features"]), train=False,
        )["params"]
        loss_fn = make_loss_fn(cfg, model)
        l_solo, _ = loss_fn(params, solo, jax.random.PRNGKey(0), False)
        l_pad, _ = loss_fn(params, padded, jax.random.PRNGKey(0), False)
        np.testing.assert_allclose(float(l_solo), float(l_pad), rtol=1e-5)


class TestTrainSmoke:
    def test_loss_decreases_and_per_beats_chance(self, tiny_cfg):
        state, metrics = train(tiny_cfg)
        assert metrics["loss"] < 1.0, f"loss did not converge: {metrics}"
        ds = SyntheticDataset(
            vocab=tiny_cfg.model.vocab,
            n_mels=tiny_cfg.data.n_mels,
            num_examples=tiny_cfg.data.num_synthetic,
            seed=tiny_cfg.train.seed,
        )
        dev = evaluate(tiny_cfg, state.params, ds, make_eval_step(tiny_cfg))
        assert dev["per"] < 0.5, f"greedy PER not better than chance: {dev}"
        # beam-search eval protocol (final-numbers path): beam should never
        # score worse than greedy on the same params by a wide margin
        dev_beam = evaluate(
            tiny_cfg, state.params, ds, make_eval_step(tiny_cfg), beam=True
        )
        assert np.isfinite(dev_beam["loss"])
        assert dev_beam["per"] <= dev["per"] + 0.05, (
            f"beam PER {dev_beam['per']} much worse than greedy {dev['per']}"
        )

    def test_checkpoint_roundtrip_and_resume(self, tiny_cfg):
        # depends on the checkpoints written by the previous test
        ckpt = CheckpointManager(tiny_cfg)
        step = ckpt.latest_step()
        assert step is not None and step >= 110
        ds = SyntheticDataset(
            vocab=tiny_cfg.model.vocab, n_mels=tiny_cfg.data.n_mels,
            num_examples=8, seed=0,
        )
        batch = next(iter(epoch_iterator(ds, tiny_cfg.data, train=False)))
        fresh = create_train_state(
            tiny_cfg, jax.random.PRNGKey(123), batch["features"]
        )
        restored = ckpt.restore(step, fresh)
        assert int(restored.step) == step
        # restored params differ from fresh init and produce finite loss
        train_step = make_train_step(tiny_cfg)
        new_state, m = train_step(restored, {k: np.asarray(v) for k, v in batch.items()})
        assert np.isfinite(float(m["loss"]))
        assert int(new_state.step) == step + 1


class TestNativeScorer:
    def test_native_builds_and_matches_python(self):
        from qasr.decode import scoring

        if scoring._native_ed is None:
            import pytest
            pytest.skip("native toolchain unavailable")
        rng = np.random.RandomState(0)
        for _ in range(20):
            a = list(rng.randint(0, 10, size=rng.randint(0, 30)))
            b = list(rng.randint(0, 10, size=rng.randint(0, 30)))
            assert scoring._native_ed(a, b) == scoring._edit_distance_py(a, b)

    def test_native_batch_matches(self):
        from qasr.decode.scoring import batch_per
        rng = np.random.RandomState(1)
        refs = rng.randint(1, 9, size=(6, 12)).astype(np.int32)
        hyps = rng.randint(1, 9, size=(6, 15)).astype(np.int32)
        rl = rng.randint(1, 13, size=6).astype(np.int32)
        hl = rng.randint(0, 16, size=6).astype(np.int32)
        errs, total = batch_per(refs, rl, hyps, hl, fold=False)
        # python oracle
        from qasr.decode.scoring import _edit_distance_py
        e2 = sum(_edit_distance_py(list(refs[i, :rl[i]]), list(hyps[i, :hl[i]])) for i in range(6))
        assert (errs, total) == (e2, int(rl.sum()))

    def test_folded_per_via_timit_ids(self):
        from qasr.decode.scoring import per_counts
        from qasr.data.timit import PHONE_TO_ID
        # "ao" folds to "aa"; "q" is deleted
        ref = [PHONE_TO_ID["aa"], PHONE_TO_ID["q"], PHONE_TO_ID["sh"]]
        hyp = [PHONE_TO_ID["ao"], PHONE_TO_ID["zh"]]
        errs, n = per_counts(ref, hyp, fold=True)
        assert (errs, n) == (0, 2)


class TestRemat:
    def test_remat_step_matches_plain(self):
        cfg = get_config("tiny_synthetic").override(**{"train.num_steps": 5})
        cfg_r = cfg.override(**{"train.remat_convs": True})
        ds = SyntheticDataset(vocab=cfg.model.vocab, n_mels=cfg.data.n_mels,
                              num_examples=8, seed=0)
        batch = dict(next(iter(epoch_iterator(ds, cfg.data, train=False))))
        s1 = create_train_state(cfg, jax.random.PRNGKey(0), batch["features"])
        s2 = create_train_state(cfg_r, jax.random.PRNGKey(0), batch["features"])
        _, m1 = make_train_step(cfg)(s1, batch)
        _, m2 = make_train_step(cfg_r)(s2, batch)
        np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]), rtol=1e-5)
        np.testing.assert_allclose(
            float(m1["grad_norm"]), float(m2["grad_norm"]), rtol=1e-4
        )

    def test_remat_composes_with_stacked_custom_vjp(self):
        """jax.checkpoint over the rank-8 stacked chain (whose dx/dW come
        from a custom VJP) must reproduce plain grads exactly."""
        from qasr.models.qcnn import QCNNEncoder

        m = QCNNEncoder(
            variant="stacked8",
            conv_features=(8, 128),
            dense_features=(8,),
            vocab=8,
            pool_after=1,
        )
        x = jax.random.normal(jax.random.PRNGKey(0), (2, 16, 40, 4))
        p = m.init(jax.random.PRNGKey(1), x, train=False)["params"]

        import jax.numpy as jnp

        def loss(p):
            return jnp.sum(m.apply({"params": p}, x, train=False) ** 2)

        g1 = jax.tree_util.tree_leaves(jax.grad(loss)(p))
        g2 = jax.tree_util.tree_leaves(jax.grad(jax.checkpoint(loss))(p))
        for a, b in zip(g1, g2):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


class TestBatchStream:
    def test_resume_reproduces_exact_batches(self):
        from qasr.data.batching import BatchStream

        ds = SyntheticDataset(vocab=12, n_mels=8, num_examples=32, seed=0)
        cfg = get_config("tiny_synthetic").data
        a = BatchStream(ds, cfg, seed=5)
        consumed = [next(a) for _ in range(9)]  # crosses an epoch boundary
        saved = a.state()
        next_batches = [next(a) for _ in range(3)]

        b = BatchStream(ds, cfg, seed=5)
        b.restore(saved)
        for want in next_batches:
            got = next(b)
            np.testing.assert_array_equal(got["features"], want["features"])
            np.testing.assert_array_equal(got["labels"], want["labels"])

    def test_prefetcher_pairs_batches_with_exact_state(self):
        """Under background prefetch, the state yielded WITH a batch must be
        the stream position just after that batch, so a checkpoint written
        while prefetch runs ahead resumes on the very next batch."""
        from qasr.data.batching import BatchStream, Prefetcher

        ds = SyntheticDataset(vocab=12, n_mels=8, num_examples=32, seed=0)
        cfg = get_config("tiny_synthetic").data
        stream = BatchStream(ds, cfg, seed=5)
        pf = Prefetcher(stream, depth=2)
        try:
            pulled = [next(pf) for _ in range(7)]
        finally:
            pf.close()

        for i in range(len(pulled) - 1):
            _, state = pulled[i]
            fresh = BatchStream(ds, cfg, seed=5)
            fresh.restore(state)
            want = pulled[i + 1][0]
            got = next(fresh)
            np.testing.assert_array_equal(got["features"], want["features"])
            np.testing.assert_array_equal(got["labels"], want["labels"])


class TestPrefetcher:
    def test_propagates_producer_exception(self):
        from qasr.data.batching import Prefetcher

        class Boom:
            def state(self):
                return {}

            def __next__(self):
                raise ValueError("dataset exploded")

        p = Prefetcher(Boom(), depth=1)
        try:
            with pytest.raises(RuntimeError, match="prefetch thread failed"):
                next(p)
            # the producer thread has exited: a second __next__ must re-raise
            # immediately (sticky error), not block on the empty queue forever
            with pytest.raises(RuntimeError, match="prefetch thread failed"):
                next(p)
        finally:
            p.close()
