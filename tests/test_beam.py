"""Prefix beam search tests (SURVEY.md §4 test 4: decode).

Oracle: exhaustive path-sum over all label sequences on tiny T/V — the beam
with W >= #sequences must find the exact argmax of the true CTC posterior.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qasr.decode.beam import ctc_beam_search_decode
from qasr.ops.ctc import ctc_greedy_decode, ctc_loss


def _exhaustive_best(logp, t, v, blank, max_len):
    """Enumerate all collapsed label sequences and sum path probs exactly."""
    probs = {}
    for path in itertools.product(range(v), repeat=t):
        p = float(sum(logp[i, s] for i, s in enumerate(path)))
        # collapse
        seq = []
        prev = None
        for s in path:
            if s != blank and s != prev:
                seq.append(s)
            prev = s
        seq = tuple(seq[:max_len + 1])
        key = seq
        probs[key] = np.logaddexp(probs[key], p) if key in probs else p
    return max(probs.items(), key=lambda kv: kv[1])


class TestBeamSearch:
    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    def test_exact_on_tiny(self, seed):
        t, v, w = 5, 3, 16
        logits = jax.random.normal(jax.random.PRNGKey(seed), (1, t, v)) * 2.0
        logp = np.asarray(jax.nn.log_softmax(logits[0]))
        want_seq, want_score = _exhaustive_best(logp, t, v, 0, max_len=t)
        seq, lens, score = ctc_beam_search_decode(
            logits, jnp.array([t]), beam_width=w, max_len=t
        )
        got = tuple(int(x) for x in np.asarray(seq[0][: int(lens[0])]))
        assert got == want_seq, f"{got} != {want_seq}"
        np.testing.assert_allclose(float(score[0]), want_score, rtol=1e-4)

    def test_beam_score_bounded_by_true_posterior(self):
        # The beam's accumulated score can only UNDERESTIMATE the true prefix
        # posterior (pruning drops contributing paths), and must be a valid
        # log-probability; with a wide beam it should be close.
        logits = jax.random.normal(jax.random.PRNGKey(5), (3, 12, 5))
        lens = jnp.array([12, 9, 7])
        seq, out_lens, score = ctc_beam_search_decode(
            logits, lens, beam_width=32, max_len=12
        )
        for i in range(3):
            li = int(out_lens[i])
            if li == 0:
                continue
            labels = np.full((1, 12), 1, np.int32)
            labels[0, :li] = np.asarray(seq[i, :li])
            nll = ctc_loss(
                logits[i : i + 1],
                jnp.asarray(labels),
                lens[i : i + 1],
                jnp.array([li]),
            )
            true_post = -float(nll[0])
            assert float(score[i]) <= true_post + 1e-3
            assert float(score[i]) >= true_post - 0.5  # wide beam: close

    def test_peaky_logits_match_greedy(self):
        # when the posterior is near-deterministic, beam == greedy
        path = jnp.array([[0, 1, 1, 0, 2, 2, 3, 0, 0, 1]])
        logits = jax.nn.one_hot(path, 5) * 12.0
        lens = jnp.array([10])
        g_seq, g_lens = ctc_greedy_decode(logits, lens)
        b_seq, b_lens, _ = ctc_beam_search_decode(logits, lens, beam_width=4, max_len=10)
        assert int(b_lens[0]) == int(g_lens[0])
        np.testing.assert_array_equal(
            np.asarray(b_seq[0][: int(b_lens[0])]),
            np.asarray(g_seq[0][: int(g_lens[0])]),
        )

    def test_beam_improves_or_matches_greedy_posterior(self):
        # the beam's best prefix must have posterior >= the greedy prefix's
        logits = jax.random.normal(jax.random.PRNGKey(9), (4, 30, 10)) * 1.5
        lens = jnp.full((4,), 30)
        g_seq, g_lens = ctc_greedy_decode(logits, lens)
        b_seq, b_lens, _ = ctc_beam_search_decode(
            logits, lens, beam_width=16, max_len=30
        )

        def true_posterior(i, seq, li):
            labels = np.full((1, 30), 1, np.int32)
            if li:
                labels[0, :li] = np.asarray(seq[i, :li])
            return -float(
                ctc_loss(
                    logits[i : i + 1], jnp.asarray(labels), lens[i : i + 1],
                    jnp.array([li]),
                )[0]
            )

        for i in range(4):
            g_post = true_posterior(i, g_seq, int(g_lens[i]))
            b_post = true_posterior(i, b_seq, int(b_lens[i]))
            assert b_post >= g_post - 1e-3, (b_post, g_post)

    def test_batch_and_length_masking(self):
        logits = jax.random.normal(jax.random.PRNGKey(11), (2, 25, 6))
        # second utterance sees only 5 frames
        seq_full, lens_full, _ = ctc_beam_search_decode(
            logits, jnp.array([25, 5]), beam_width=8, max_len=25
        )
        seq_cut, lens_cut, _ = ctc_beam_search_decode(
            logits[1:, :5], jnp.array([5]), beam_width=8, max_len=25
        )
        assert int(lens_full[1]) == int(lens_cut[0])
        np.testing.assert_array_equal(
            np.asarray(seq_full[1][: int(lens_full[1])]),
            np.asarray(seq_cut[0][: int(lens_cut[0])]),
        )


class TestNativeBeam:
    """Host-side C++ decoder (qasr/native/beam_decode.cpp) parity."""

    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    def test_exact_on_tiny(self, seed):
        from qasr.native import ctc_beam_decode_native

        t, v, w = 5, 3, 16
        logits = jax.random.normal(jax.random.PRNGKey(seed), (1, t, v)) * 2.0
        logp = np.asarray(jax.nn.log_softmax(logits[0]))
        want_seq, want_score = _exhaustive_best(logp, t, v, 0, max_len=t)
        seq, lens, score = ctc_beam_decode_native(
            np.asarray(logits), np.array([t]), beam_width=w, max_len=t
        )
        got = tuple(int(x) for x in seq[0][: int(lens[0])])
        assert got == want_seq, f"{got} != {want_seq}"
        np.testing.assert_allclose(float(score[0]), want_score, rtol=1e-4)

    def test_matches_device_beam(self):
        # same algorithm + exact merge on both sides -> identical hypotheses
        from qasr.native import ctc_beam_decode_native

        logits = jax.random.normal(jax.random.PRNGKey(7), (6, 40, 12)) * 1.5
        lens = jnp.array([40, 33, 40, 8, 1, 17])
        d_seq, d_lens, d_score = ctc_beam_search_decode(
            logits, lens, beam_width=8, max_len=40
        )
        n_seq, n_lens, n_score = ctc_beam_decode_native(
            np.asarray(logits), np.asarray(lens), beam_width=8, max_len=40
        )
        for i in range(6):
            assert int(n_lens[i]) == int(d_lens[i]), i
            np.testing.assert_array_equal(
                n_seq[i, : int(n_lens[i])],
                np.asarray(d_seq[i, : int(d_lens[i])]),
            )
            np.testing.assert_allclose(
                float(n_score[i]), float(d_score[i]), rtol=1e-3, atol=1e-3
            )

    def test_max_len_truncation_and_padding(self):
        # All 3-token increasing subsequences of 1..5 tie here, so assert
        # structure + score parity with the device beam, not a specific tie.
        from qasr.native import ctc_beam_decode_native

        path = jnp.array([[1, 0, 2, 0, 3, 0, 4, 0, 5, 0]])
        logits = jax.nn.one_hot(path, 8) * 12.0
        seq, lens, score = ctc_beam_decode_native(
            np.asarray(logits), np.array([10]), beam_width=4, max_len=3
        )
        assert int(lens[0]) == 3
        toks = list(seq[0])
        assert all(1 <= t <= 5 for t in toks) and toks == sorted(toks)
        _, d_lens, d_score = ctc_beam_search_decode(
            logits, jnp.array([10]), beam_width=4, max_len=3
        )
        assert int(d_lens[0]) == 3
        np.testing.assert_allclose(float(score[0]), float(d_score[0]), rtol=1e-4)

    def test_host_wrapper_dispatch(self):
        from qasr.decode import ctc_beam_search_decode_host

        logits = jax.random.normal(jax.random.PRNGKey(3), (2, 10, 5))
        seq, lens, score = ctc_beam_search_decode_host(
            logits, jnp.array([10, 6]), beam_width=4, max_len=10
        )
        assert seq.shape == (2, 10) and lens.shape == (2,)


class TestProtocolWidth:
    """Reference decode protocol: beam_width=100 at the TIMIT vocab V=62
    (preset `configs/config.py` timit presets). The [W,V,W] merge and top_k
    must hold up at protocol width, matching the exact-merge C++ decoder on
    the same logits."""

    def _parity(self, prune, seed=17, b=3, t=80, v=62, w=100, max_len=60):
        from qasr.native import ctc_beam_decode_native

        logits = jax.random.normal(jax.random.PRNGKey(seed), (b, t, v)) * 2.0
        lens = jnp.array([t, t - 7, t // 2])
        d_seq, d_lens, d_score = ctc_beam_search_decode(
            logits, lens, beam_width=w, max_len=max_len, prune_logp=prune
        )
        n_seq, n_lens, n_score = ctc_beam_decode_native(
            np.asarray(logits, np.float32),
            np.asarray(lens),
            beam_width=w,
            max_len=max_len,
            prune_logp=prune,
        )
        for i in range(b):
            assert int(d_lens[i]) == int(n_lens[i]), (i, d_lens, n_lens)
            li = int(d_lens[i])
            np.testing.assert_array_equal(
                np.asarray(d_seq[i, :li]), n_seq[i, :li]
            )
            np.testing.assert_allclose(
                float(d_score[i]), float(n_score[i]), rtol=1e-3, atol=2e-3
            )

    def test_w100_v62_matches_native(self):
        self._parity(prune=None)

    def test_w100_v62_with_pruning_matches_native(self):
        # -3.0 actually prunes at V=62 (mean logp ~ -4.4), so this exercises
        # the pruning branch in both decoders, not just the knob plumbing
        self._parity(prune=-3.0, seed=23)

    def test_pruning_drops_low_prob_extensions(self):
        # an extreme threshold leaves only blank/repeat paths -> empty prefix
        logits = jax.random.normal(jax.random.PRNGKey(2), (1, 20, 8))
        seq, lens, _ = ctc_beam_search_decode(
            logits, jnp.array([20]), beam_width=8, max_len=20, prune_logp=1e9
        )
        assert int(lens[0]) == 0


class TestFlatLogitsFloat64:
    """On the flat, blank-heavy logits of an untrained model, many prefixes
    sit within float32 rounding of each other at the beam's edge, so the
    two float32 searches can part ways. In float64 the device beam and the
    C++ beam are the same search: identical hypotheses, scores to rounding."""

    @pytest.mark.parametrize("seed,scale", [(0, 0.05), (2, 0.05), (4, 0.3)])
    def test_device_equals_native_in_float64(self, seed, scale):
        from qasr.native import ctc_beam_decode_native

        b, t, v = 16, 160, 62
        rng = np.random.RandomState(seed)
        logits = (rng.standard_normal((b, t, v)) * scale).astype(np.float64)
        logits[:, :, 0] += 1.0
        lens = np.full((b,), t, np.int32)
        kw = dict(beam_width=100, blank_id=0, max_len=80, prune_logp=-20.0)
        with jax.enable_x64(True):
            d_seq, d_lens, d_score = (
                np.asarray(a)
                for a in ctc_beam_search_decode(jnp.asarray(logits), jnp.asarray(lens), **kw)
            )
        assert d_score.dtype == np.float64
        n_seq, n_lens, n_score = ctc_beam_decode_native(logits, lens, **kw)
        assert n_score.dtype == np.float64
        np.testing.assert_array_equal(d_lens, n_lens)
        for i in range(b):
            np.testing.assert_array_equal(d_seq[i, : d_lens[i]], n_seq[i, : n_lens[i]])
        np.testing.assert_allclose(d_score, n_score, rtol=1e-12)
