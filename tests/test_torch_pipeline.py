"""The port's StreamingPipeline (device="cpu", plain versions) against the
JAX pipeline on the same seed, in every placement x fast_path cell.

Batches flush on size only (a long linger, one identify worker), so both
packages batch the same frames and faces together and their transfer
bytes, pow2 padding included, can be compared exactly.
"""
import itertools

import numpy as np
import pytest
import torch

from repro.core import facerec as jf
from repro.core.pipeline import StreamingPipeline as JaxPipeline

from repro_torch.core import facerec as tf
from repro_torch.core.pipeline import StreamingPipeline

CELLS = list(itertools.product(("host", "device"), (True, False)))
KW = dict(n_frames=24, seed=0, batch_size=4, batch_timeout_ms=60_000.0,
          n_identify_workers=1)
BOUNDARIES = ("pre_decode", "pre_letterbox", "post_nms", "detect",
              "crop_resize", "embed", "identify_fused")
FACE_BOUNDARIES = ("crop_resize", "embed", "identify_fused")


def _port_pipeline(placement, fast, params, **kw):
    """The port's pipeline with the reference embedder's weights: the
    stack is rebuilt through the public factory onto the pipeline's log."""
    pipe = StreamingPipeline(placement=placement, fast_path=fast,
                             device="cpu", **kw)
    stack = tf.build_identify_stack(seed=kw["seed"], fast_path=fast,
                                    placement=placement, log=pipe.log,
                                    params=params, device="cpu")
    pipe.embedder, pipe.classifier = stack.embedder, stack.classifier
    pipe.fused_identifier, pipe.preprocess = stack.fused, stack.preprocess
    return pipe


@pytest.fixture(scope="module")
def results():
    jemb = jf.Embedder()    # the reference stack's weights (its seed 7)
    params = tf.embedder_params_from_numpy(
        {"w1": np.asarray(jemb.w1), "w2": np.asarray(jemb.w2)})
    out = {}
    for placement, fast in CELLS:
        out[placement, fast] = (
            JaxPipeline(placement=placement, fast_path=fast, **KW).run(),
            _port_pipeline(placement, fast, params, **KW).run())
    return out


def _ids(r):
    return sorted((rid, name) for rid, name, _ in r.identities)


@pytest.mark.parametrize("placement,fast", CELLS)
def test_detections_and_identities_equal_reference(results, placement, fast):
    jr, tr = results[placement, fast]
    assert (tr.detected, tr.ground_truth, tr.matched) == \
        (jr.detected, jr.ground_truth, jr.matched)
    assert tr.detected > 0 and tr.recall == jr.recall
    assert _ids(tr) == _ids(jr)
    assert len(tr.identities) == tr.detected


@pytest.mark.parametrize("placement,fast", CELLS)
def test_scores_within_1e4_of_reference(results, placement, fast):
    jr, tr = results[placement, fast]
    # one frame may hold two faces of one identity: compare sorted scores
    jr_scores, tr_scores = sorted(jr.identities), sorted(tr.identities)
    assert [i[:2] for i in tr_scores] == [i[:2] for i in jr_scores]
    np.testing.assert_allclose([i[2] for i in tr_scores],
                               [i[2] for i in jr_scores], atol=1e-4, rtol=0)


@pytest.mark.parametrize("placement,fast", CELLS)
def test_transfer_bytes_per_boundary_equal_reference(results, placement,
                                                     fast):
    jr, tr = results[placement, fast]
    for boundary in BOUNDARIES:
        assert tr.log.transfer_bytes(boundary) == \
            jr.log.transfer_bytes(boundary), boundary
    assert tr.log.transfer_bytes() == jr.log.transfer_bytes()


@pytest.mark.parametrize("placement,fast", CELLS)
def test_five_way_split_sums_to_one(results, placement, fast):
    _, tr = results[placement, fast]
    tax = tr.ai_tax()
    assert sum(tax["fractions"].values()) == pytest.approx(1.0, abs=1e-12)
    assert set(tax["per_stage"]) >= {"pre_decode", "pre_letterbox",
                                     "post_nms", "pre_crop", "detect",
                                     "identify", "ingest", "wait_frames"}
    assert tr.batch_stats["detect"].n_items == KW["n_frames"]


@pytest.mark.parametrize("placement", ["host", "device"])
def test_fast_path_cuts_face_transfer_bytes_4x(results, placement):
    def per_face(r):
        return sum(r.log.transfer_bytes(b)["total"]
                   for b in FACE_BOUNDARIES) / r.detected
    slow, fast = results[placement, False][1], results[placement, True][1]
    assert _ids(fast) == _ids(slow)
    assert per_face(slow) >= 4 * per_face(fast)


def test_pipeline_needs_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamingPipeline()
    r = StreamingPipeline(n_frames=3, device="cpu", batch_size=2).run()
    assert r.ground_truth >= r.matched >= 0


def test_two_identify_workers_and_default_linger():
    """The default threading shape: two identify workers, 5 ms linger."""
    r = StreamingPipeline(n_frames=12, seed=0, batch_size=4,
                          device="cpu").run()
    assert len(r.identities) == r.detected > 0
    assert sum(r.ai_tax()["fractions"].values()) == pytest.approx(1.0)
