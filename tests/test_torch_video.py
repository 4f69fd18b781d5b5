"""Video and live serving of the PyTorch port against the JAX package's, on
the CPU: ``cli/video_inference.py``, ``inference/async_worker.py``,
``inference/camera.py`` and ``cli/live_inference.py``.

The log dir is ``test_torch_inference.py``'s (a seeded R-18 Localizer at
64x64 -> 16x16 and a ResnetAssessor, exported to ``.pt``); the clips are
written here with cv2 (MJPG in ``.avi``, 96x128 frames: noise with a
bright rectangle each). ``cv2.VideoWriter`` is replaced by a recorder in
every CLI run, so the frames each CLI writes are compared as arrays.

* Video, ``-a -v -b 4`` with a score threshold in the middle of the widest
  gap between the clip's scores (some frames gated, none near the gate):
  the boxes agree within 1e-3 px at model scale and the scores within 1e-5
  (``test_torch_inference.py``'s bounds), the same frames are gated, and
  the written frames are equal but where a drawn box (or its score's text)
  moves by one pixel: a scaled coordinate that lies within its tolerance
  of an integer truncates to either side. Such differing pixels are
  counted, and every one of them is a drawn pixel in one of the two
  frames. The heat-map frames agree within one uint8 step off the drawn
  pixels (the heat maps agree within 1e-5, ``test_torch_visual_backprop.py``,
  and the uint8 images truncate 255 * heat).
* The port's ``-b 1 --no-pipeline``, ``-b 1`` and ``-b 4`` (10 frames: the
  tail batch of 2 padded) write the same frames, by the same rule.
* An SSD log dir, a missing cv2 and a missing card are refused by name, and
  an output that cv2 cannot open fails (cv2 would drop every frame).
* ``AsynchronousLocalizer`` against JAX's on a stub whose ``localize``
  waits for an event: a frame submitted while the worker is busy and the
  queue full is dropped, an unfetched result is replaced by the next one,
  ``fps`` is set, and shutdown drains both queues.
* ``Camera`` over the clip's path reads the frames ``cv2.VideoCapture``
  reads.
* ``live_inference.main`` with ``cv2.imshow``/``cv2.waitKey`` replaced:
  ``+``/``=`` and ``-`` move the threshold by 0.05 within [0, 1] exactly
  as JAX's does, and ESC ends the loop.
"""

import shutil
import sys
import threading

import cv2
import numpy as np
import pytest
import torch

from loans_tpu.cli import live_inference as jlive
from loans_tpu.cli import video_inference as jvideo
from loans_tpu.inference import AsynchronousLocalizer as JaxAsynchronousLocalizer
from loans_tpu.inference import localizer as jlocalizer
from loans_tpu_torch.cli import live_inference, video_inference
from loans_tpu_torch.inference import AsynchronousLocalizer, LocalizerInference
from loans_tpu_torch.inference.camera import Camera
from loans_tpu_torch.train import checkpoint
from test_torch_inference import log_dir  # noqa: F401  (the shared log dir fixture)

H, W = 96, 128


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module, the worker's count put back
    after: the tier-1 run shares the cores among its workers, where
    threads that wait on each other's barriers run several times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def _remove_log_dir(log_dir):  # noqa: F811
    yield
    shutil.rmtree(log_dir)  # this module's copy of the shared log dir


def write_clip(path, n, seed):
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 128, size=(n, H, W, 3), dtype=np.uint8)
    for f in frames:
        y, x = rng.integers(0, H // 2), rng.integers(0, W // 2)
        f[y : y + rng.integers(H // 4, H // 2), x : x + rng.integers(W // 4, W // 2)] = rng.integers(180, 256, 3)
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 10.0, (W, H))
    for f in frames:
        writer.write(f)
    writer.release()
    return str(path)


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    return write_clip(tmp_path_factory.mktemp("clip") / "clip.avi", 10, seed=3)


def decoded(path):
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    return frames


class Recorder:
    """Stands in for ``cv2.VideoWriter``: keeps each written frame."""

    written: dict = {}

    def __init__(self, path, fourcc, fps, size):
        self.path, self.size = path, size
        Recorder.written[path] = []

    def write(self, frame):
        assert frame.shape[:2] == (self.size[1], self.size[0])
        Recorder.written[self.path].append(frame.copy())

    def isOpened(self):
        return True

    def release(self):
        pass


@pytest.fixture
def recorder(monkeypatch):
    Recorder.written = {}
    monkeypatch.setattr(cv2, "VideoWriter", Recorder)
    return Recorder.written


def run(cli, argv, written):
    """The frames ``cli.main(argv)`` writes, by output, and its return."""
    written.clear()
    out = cli.main(argv)
    return {k: list(v) for k, v in written.items()}, out


def drawn(frame, source, steps=0):
    """The pixels of ``frame`` more than ``steps`` levels off ``source``."""
    return np.abs(frame.astype(int) - source.astype(int)).max(axis=-1) > steps


def assert_frames_match(got, want, sources, steps=0):
    """Equal (within ``steps`` uint8 levels) off the pixels that either
    frame drew over ``sources`` (``want``'s undrawn frames; ``got``'s lie
    within ``steps`` of them); returns how many drawn pixels differ."""
    moved = 0
    for g, w, s in zip(got, want, sources):
        off = drawn(g, w, steps)
        on_drawing = drawn(g, s, steps) | drawn(w, s)
        assert not (off & ~on_drawing).any(), "a difference off the drawn box"
        moved += int(off.sum())
    return moved


def threshold_in_gap(log_dir, frames):  # noqa: F811
    """The middle of the widest gap between the frames' assessor scores."""
    inf = LocalizerInference(log_dir, device="cpu", use_assessor=True, score_threshold=0.0)
    inputs = [inf.preprocess(inf.resize(f)[0], bgr_to_rgb=True) for f in frames]
    scores = np.sort(inf.localize_batch(inputs)[2])
    gap = int(np.argmax(np.diff(scores)))
    return float(scores[gap] + scores[gap + 1]) / 2


def test_video_cli_matches_jax(log_dir, clip, tmp_path, recorder, monkeypatch):  # noqa: F811
    sources = decoded(clip)
    thr = threshold_in_gap(log_dir, sources)
    results = {"jax": [], "port": []}
    for tag, cls in (("jax", jlocalizer.LocalizerInference), ("port", LocalizerInference)):
        def recorded(self, out, finish=cls.finish_batch, tag=tag):
            res = finish(self, out)
            results[tag].append(res)
            return res

        monkeypatch.setattr(cls, "finish_batch", recorded)
    argv = [log_dir, "-i", clip, "-o", str(tmp_path / "out.avi"), "-a", "-v", "-b", "4",
            "--score-threshold", str(thr)]
    jwritten, _ = run(jvideo, argv, recorder)
    pwritten, out = run(video_inference, argv + ["--device", "cpu"], recorder)

    vbp_path = str(tmp_path / "out_visual_backprop.avi")
    assert sorted(pwritten) == sorted(jwritten) == sorted([str(tmp_path / "out.avi"), vbp_path])
    assert out["frames"] == 10 and out["output"] == str(tmp_path / "out.avi")
    jboxes = np.concatenate([r[0][:, 0] for r in results["jax"]])[:10]
    jscores = np.concatenate([r[2] for r in results["jax"]])[:10]
    np.testing.assert_allclose(out["boxes"], jboxes, rtol=0, atol=1e-3)
    np.testing.assert_allclose(np.concatenate([r[2] for r in results["port"]])[:10], jscores, rtol=0, atol=1e-5)
    gated = jscores == 0.0
    assert 0 < gated.sum() < 10
    np.testing.assert_array_equal((out["boxes"] == 0).all(axis=1), gated)

    main = str(tmp_path / "out.avi")
    assert len(pwritten[main]) == len(jwritten[main]) == 10
    moved = assert_frames_match(pwritten[main], jwritten[main], sources)
    for got, s, gate in zip(pwritten[main], sources, gated):
        assert drawn(got, s).any() != gate  # a box drawn on each kept frame, none on a gated one
    # the heat-map frames: within one step off the drawn pixels
    heats = [cv2.resize(h[..., ::-1], (W, H)) for r in results["jax"] for h in r[3]][:10]
    moved += assert_frames_match(pwritten[vbp_path], jwritten[vbp_path], heats, steps=1)
    print(f"drawn pixels moved by a coordinate within its tolerance of an integer: {moved}")


def test_batch_sizes_and_no_pipeline_agree(log_dir, clip, tmp_path, recorder):  # noqa: F811
    sources = decoded(clip)
    outs = {}
    for tag, extra in {"b1_serial": ["-b", "1", "--no-pipeline"], "b1": ["-b", "1"], "b4": ["-b", "4"]}.items():
        written, out = run(video_inference, [log_dir, "-i", clip, "-o", str(tmp_path / f"{tag}.avi"), "-a",
                                             "--score-threshold", "0.0", "--device", "cpu"] + extra, recorder)
        assert list(written) == [str(tmp_path / f"{tag}.avi")] and out["frames"] == 10
        outs[tag] = (written[str(tmp_path / f"{tag}.avi")], out["boxes"])
    for tag in ("b1", "b4"):
        np.testing.assert_allclose(outs[tag][1], outs["b1_serial"][1], rtol=0, atol=1e-3)
        assert_frames_match(outs[tag][0], outs["b1_serial"][0], sources)


def test_video_cli_refusals(log_dir, clip, tmp_path, monkeypatch):  # noqa: F811
    ssd = tmp_path / "ssd"
    checkpoint.save_manifest(str(ssd), {"localizer": {"model": "SSD300", "kwargs": {}}})
    with pytest.raises(SystemExit, match="SSD log dir.*SSDInference"):
        video_inference.main([str(ssd), "-i", clip, "--device", "cpu"])
    with pytest.raises(SystemExit, match="could not open .*missing/out.avi for writing"):
        video_inference.main([log_dir, "-i", clip, "-o", str(tmp_path / "missing" / "out.avi"), "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        video_inference.main([log_dir, "-i", clip])
    monkeypatch.setitem(sys.modules, "cv2", None)
    for cli in (video_inference, live_inference):
        with pytest.raises(SystemExit, match=r"OpenCV \(cv2\)"):
            cli.main([log_dir, "-i" if cli is video_inference else "-c", clip, "--device", "cpu"])


class StubLocalizer:
    """``localize(i)`` waits until ``release(i)``; records what it got."""

    def __init__(self):
        self.calls = []
        self.entered = {i: threading.Event() for i in range(8)}
        self.released = {i: threading.Event() for i in range(8)}

    def localize(self, image):
        self.calls.append(image)
        self.entered[image].set()
        assert self.released[image].wait(10)
        return f"result {image}"


def worker_story(cls):
    """What an ``AsynchronousLocalizer`` class does with a busy stub."""
    stub = StubLocalizer()
    w = cls(stub).start_localization_worker()
    story = [w.submit(1)]
    assert stub.entered[1].wait(10)  # the worker holds frame 1
    story += [w.submit(2), w.submit(3), w.get_result()]  # 2 queued, 3 dropped
    stub.released[1].set()
    assert stub.entered[2].wait(10)  # result 1 is out, frame 2 taken
    stub.released[2].set()
    story.append(w.submit(4))
    assert stub.entered[4].wait(10)  # result 2 replaced result 1
    story += [w.get_result(), w.get_result(), w.fps > 0, w.submit(5)]
    threading.Timer(0.2, stub.released[4].set).start()
    w.shutdown()
    story += [w.localization_queue.empty(), w.image_queue.empty(), not w._worker.is_alive(), stub.calls]
    return story


def test_async_worker_matches_jax():
    want = [True, True, False, None, True, "result 2", None, True, True, True, True, True, [1, 2, 4]]
    assert worker_story(JaxAsynchronousLocalizer) == want
    assert worker_story(AsynchronousLocalizer) == want


def test_camera_reads_the_clip(clip):
    want = decoded(clip)
    with Camera(clip) as cam:
        got = [cam.get_frame() for _ in want]
        with pytest.raises(RuntimeError, match="camera read failed"):
            cam.get_frame()
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    with pytest.raises(RuntimeError, match="could not open camera"):
        with Camera(clip + ".missing"):
            pass


KEYS = [ord("+")] * 3 + [ord("-")] * 22 + [ord("="), ord("b"), 27]


def live_thresholds(cli, inference_module, argv, monkeypatch):
    """The score threshold before each key of ``KEYS`` and after the
    last, and the frames shown."""
    seen, shown, keys = {}, [], iter(KEYS)
    build = inference_module.load_inference

    def load(*a, **k):
        seen["localizer"] = build(*a, **k)
        return seen["localizer"]

    def wait_key(delay):
        thresholds.append(seen["localizer"].score_threshold)
        return next(keys)

    thresholds = []
    monkeypatch.setattr(inference_module, "load_inference", load)
    monkeypatch.setattr(cv2, "imshow", lambda name, frame: shown.append(frame))
    monkeypatch.setattr(cv2, "waitKey", wait_key)
    monkeypatch.setattr(cv2, "destroyAllWindows", lambda: None)
    cli.main(argv)
    return thresholds + [seen["localizer"].score_threshold], shown


def test_live_cli_hotkeys_match_jax(log_dir, tmp_path, monkeypatch):  # noqa: F811
    import loans_tpu.inference.ssd as jssd_inference
    import loans_tpu_torch.inference as port_inference

    clip = write_clip(tmp_path / "live.avi", len(KEYS) + 2, seed=4)
    argv = [log_dir, "-c", clip, "-a", "--score-threshold", "0.9"]
    # JAX's live CLI opens Camera(int) only; here it is handed the clip's path
    monkeypatch.setattr(jlive, "get_parser", live_inference.get_parser)
    want, jshown = live_thresholds(jlive, jssd_inference, argv, monkeypatch)
    got, shown = live_thresholds(live_inference, port_inference, argv + ["--device", "cpu"], monkeypatch)
    assert got == want and len(got) == len(KEYS) + 1
    assert max(got) == 1.0 and min(got) == 0.0 and got[-1] == 0.05
    assert all(0.0 <= t <= 1.0 for t in got)
    assert len(shown) == len(jshown) == len(KEYS)
    assert all(f.shape == (H, W, 3) for f in shown)
