"""The port's face models and pre/post-processing stage against the JAX
package, with the reference embedder's weights carried across as numpy."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import facerec as jf
from repro.data.video import VideoStream as JaxVideoStream
from repro.preprocess import PreprocessStage as JaxStage
from repro.preprocess import host as jax_host

from repro_torch.core import facerec as tf
from repro_torch.core.events import EventLog
from repro_torch.data.video import VideoStream
from repro_torch.preprocess import PreprocessStage
from repro_torch.preprocess import host as port_host

CPU = "cpu"


@pytest.fixture(scope="module")
def models():
    """(jax embedder, jax classifier, port embedder, port classifier): same
    weights, galleries embedded from the same numpy thumbnails."""
    jemb = jf.Embedder()
    params = tf.embedder_params_from_numpy(
        {"w1": np.asarray(jemb.w1), "w2": np.asarray(jemb.w2)})
    temb = tf.Embedder(params=params, device=CPU)
    thumbs = np.random.default_rng(0).uniform(
        0, 255, (6, tf.THUMB, tf.THUMB, 3)).astype(np.float32)
    jgal = jemb.embed_batch(thumbs)
    tgal = temb.embed_batch(thumbs)
    return (jemb, jf.Classifier({f"p{i}": e for i, e in enumerate(jgal)}),
            temb, tf.Classifier({f"p{i}": e for i, e in enumerate(tgal)}))


def _frames_with_faces(n, seed=3):
    vs = JaxVideoStream(seed=seed)
    frames, centers = [], []
    while sum(len(c) for c in centers) < n:
        f = vs.next_frame().pixels
        frames.append(f)
        centers.append(jf.detect_faces(f))
    return frames, centers


def test_video_stream_same_frames_from_one_seed():
    a, b = JaxVideoStream(seed=5), VideoStream(seed=5)
    for _ in range(4):
        fa, fb = a.next_frame(), b.next_frame()
        np.testing.assert_array_equal(fa.pixels, fb.pixels)
        assert fa.true_boxes == fb.true_boxes


def test_heatmap_within_1e4_of_reference():
    frames = np.stack([JaxVideoStream(seed=s).next_frame().pixels
                       for s in range(4)])
    want = np.asarray(jf.detect_heatmap_batch(jnp.asarray(frames)))
    got = tf.detect_heatmap_batch(torch.from_numpy(frames)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_crop_stacks_equal_reference():
    frames, centers = _frames_with_faces(5)
    centers[0] = centers[0] + [(2, 3), (400, 900)]     # clipped windows
    (jc, jn), (tc, tn) = (jf.crop_stacks(frames, centers),
                          tf.crop_stacks(frames, centers))
    np.testing.assert_array_equal(jc, tc)
    assert jn == tn
    assert tf.crop_stacks(frames[:1], [[]]) == (None, [0])


def test_embedder_matches_reference(models):
    jemb, _, temb, _ = models
    x = np.random.default_rng(1).uniform(
        0, 255, (5, tf.THUMB, tf.THUMB, 3)).astype(np.float32)
    np.testing.assert_allclose(temb.embed_batch(x), jemb.embed_batch(x),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("n_faces", [1, 3, 8])
def test_fused_identifier_matches_reference(models, n_faces):
    """Carried weights: names exact, scores within 1e-4, ragged batches."""
    jemb, jclf, temb, tclf = models
    frames, centers = _frames_with_faces(n_faces)
    want = jf.FusedIdentifier(jemb, jclf).identify_batch(frames, centers)
    got = tf.FusedIdentifier(temb, tclf).identify_batch(frames, centers)
    assert [len(g) for g in got] == [len(w) for w in want]
    for (n1, s1), (n2, s2) in zip(sum(want, []), sum(got, [])):
        assert n1 == n2
        assert s2 == pytest.approx(s1, abs=1e-4)


def test_unfused_chain_matches_reference_and_fused(models):
    jemb, jclf, temb, tclf = models
    frames, centers = _frames_with_faces(6)
    jthumbs = sum(jf.crop_thumbnails_batch(frames, centers), [])
    tthumbs = sum(tf.crop_thumbnails_batch(frames, centers, device=CPU), [])
    np.testing.assert_allclose(np.stack(tthumbs), np.stack(jthumbs),
                               atol=1e-3, rtol=0)
    want = jclf.identify_batch(jemb.embed_batch(np.stack(jthumbs)))
    got = tclf.identify_batch(temb.embed_batch(np.stack(tthumbs)))
    fused = sum(tf.FusedIdentifier(temb, tclf).identify_batch(frames,
                                                              centers), [])
    assert [n for n, _ in got] == [n for n, _ in want] == [n for n, _ in fused]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                               atol=1e-4)


def test_build_identify_stack_matches_reference_gallery():
    jstack = jf.build_identify_stack(seed=2, gallery_size=5, fast_path=True,
                                     placement="device")
    params = tf.embedder_params_from_numpy(
        {"w1": np.asarray(jstack.embedder.w1),
         "w2": np.asarray(jstack.embedder.w2)})
    tstack = tf.build_identify_stack(seed=2, gallery_size=5, fast_path=True,
                                     placement="device", params=params,
                                     device=CPU)
    assert tstack.classifier.names == jstack.classifier.names
    np.testing.assert_allclose(tstack.classifier.mat, jstack.classifier.mat,
                               atol=1e-5)
    np.testing.assert_allclose(tstack.fused.w1f.numpy(),
                               np.asarray(jstack.fused.w1f), atol=1e-7)
    assert tstack.preprocess.placement == "device"


def test_default_weights_follow_the_torch_seed():
    a, b = tf.Embedder(seed=3, device=CPU), tf.Embedder(seed=3, device=CPU)
    c = tf.Embedder(seed=4, device=CPU)
    assert torch.equal(a.w1, b.w1) and torch.equal(a.w2, b.w2)
    assert not torch.equal(a.w1, c.w1)
    assert a.w1.shape == (tf.THUMB * tf.THUMB * 3, 256)
    assert a.w2.shape == (256, tf.EMBED_DIM)


def test_entry_points_need_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tf.build_identify_stack()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PreprocessStage("device")
    assert tf.build_identify_stack(gallery_size=2, device=CPU).fused is not None


# ---- pre/post-processing stage ----------------------------------------------

@pytest.mark.parametrize("placement", ["host", "device"])
def test_stage_ingest_matches_reference(placement):
    frame = JaxVideoStream(seed=4).next_frame().pixels
    yuv = jax_host.rgb_to_yuv(frame)[None]
    np.testing.assert_array_equal(port_host.rgb_to_yuv(frame)[None], yuv)
    jlog, tlog = None, EventLog()
    want = JaxStage(placement, log=jlog).ingest(yuv, 108, 192, rids=[0])
    stage = PreprocessStage(placement, log=tlog, device=CPU)
    got = stage.ingest(yuv, 108, 192, rids=[0])
    # 2:1 downscale: every output is a quarter-sum of four pixels, exact
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(stage.decode(yuv), jax_host.yuv_to_rgb(yuv))
    assert {e.stage for e in tlog.events} >= {"pre_decode", "pre_letterbox"}
    crossings = [e for e in tlog.events if e.meta.get("kind") == "transfer"]
    assert bool(crossings) == (placement == "device")


@pytest.mark.parametrize("placement", ["host", "device"])
def test_stage_postprocess_keeps_equal_reference(placement):
    """Keep decisions are bit-identical, including ties and empty frames."""
    rng = np.random.default_rng(7)
    hms = rng.uniform(0, 70, (5, 27, 48)).astype(np.float32)
    hms[1] = 0.0
    hms[2, 3:6, 3:6] = 80.0                 # a plateau of equal scores
    want = JaxStage(placement).postprocess(hms, tf.DETECT_POOL)
    got = PreprocessStage(placement, device=CPU).postprocess(
        hms, tf.DETECT_POOL)
    assert got == want
    assert got[1] == []


def test_stage_device_transfer_bytes_match_reference():
    from repro.core.events import EventLog as JaxLog
    hms = np.random.default_rng(8).uniform(0, 70, (3, 27, 48)) \
        .astype(np.float32)
    frames = np.stack([JaxVideoStream(seed=s).next_frame().pixels
                       for s in range(3)])
    yuv = jax_host.rgb_to_yuv(frames)
    jlog, tlog = JaxLog(), EventLog()
    js, ts = JaxStage("device", log=jlog), PreprocessStage("device", log=tlog,
                                                          device=CPU)
    for stage in (js, ts):
        stage.ingest(yuv, 108, 192, rids=[0, 1, 2])
        stage.postprocess(hms, tf.DETECT_POOL, rids=[0, 1, 2])
    for boundary in ("pre_decode", "pre_letterbox", "post_nms"):
        assert tlog.transfer_bytes(boundary) == jlog.transfer_bytes(boundary)
