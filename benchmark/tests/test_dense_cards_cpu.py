"""The four-card dense cell rehearsed on the CPU at a tiny size, on four
virtual CPU shards (`run_patch_match_stereo` makes them from
`num_devices=4` on the CPU): the result line, the control judged not
correct, a traced run whose per-layer metrics read or are absent but never
raise, and the faults a four-card run can have (one card's maps lost, two
frames' maps swapped, two maps filed under each other's image at the merge
of the cards' maps), each judged not correct. The two new metric readers
read nothing on a program or a trace that lacks what they read."""

import io
import json
import threading
import types

import numpy as np
import pytest

from benchmark import harness, run
from benchmark.reference import dense as plain
from benchmark.reference import dense_cards as reference

CELL = "tum_rgbd_fr3_4gpu.dense_cards"
# the cell at 160x120 (the camera scaled with the frame), one frame a card
TINY = dict(frames=4, frame_step=20, width=160, height=120,
            camera=dict(fx=535.4 / 4, fy=539.2 / 4, cx=320.1 / 4,
                        cy=247.6 / 4), texture_res=512)
SECONDS = 0.5


def _execute(trace=0, control=0, seed=2 ** 31 + 21):
    args = run.parse(["--workload", CELL, "--seed", str(seed),
                      "--seconds", str(SECONDS), "--trace",
                      str(trace), "--control", str(control)])
    out, err = io.StringIO(), io.StringIO()
    rc = run.execute(args, device="cpu", params=TINY, out=out, err=err)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()


def test_a_run_prints_the_result_line_and_its_control_fails():
    rc, res, err = _execute(control=1)
    assert rc == 0, err
    assert list(res)[-1] == "checks"
    assert res["correct"] is True, err
    assert res["attempted"] >= 1 and res["failed"] == 0
    want = {m["name"] for m in harness.cell_metrics(
        harness.benchmark_spec(), CELL)["end_to_end"]}
    assert set(res["metrics"]) == want == {"dense_mpix_per_s", "setup_s"}
    assert set(res["checks"]) >= {"photometric_depth_err_p50_worst_frame",
                                  "geometric_depth_err_p50_worst_frame"}
    ctl = [harness.Check(n, v["value"], v["limit"],
                         at_most=res["checks"][n]["at"] == "most")
           for n, v in res["control"].items()]
    assert not all(c.ok for c in ctl), res["control"]


def test_a_traced_run_reads_its_layers_or_leaves_them_out():
    rc, res, err = _execute(trace=1)
    assert rc == 0, err
    assert res["correct"] is True, err
    # the photometric pass on the four shards ran under the profiler
    assert res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    totals = json.loads(next(line for line in err.splitlines()
                             if line.startswith("totals "))[7:])
    assert totals["trace_reduce_s"] >= 0
    # no device ops on the CPU: the device's readers read nothing
    assert "idle_share.per_card" not in res["metrics"]
    assert "idle_share.dense" not in res["metrics"]
    # the spans' readers read the last job
    wait = res["metrics"]["dense.card_wait_share"]["value"]
    assert 0 < wait < 100
    assert res["metrics"]["dense.host_ms_per_map"]["value"] > 0
    assert res["metrics"]["patch_match.solve_ms.photometric"]["value"] > 0


def _lose_a_card(monkeypatch):
    """Shard 1's solver hands back empty depth maps: every fourth frame."""
    from colmap_tpu_torch.mvs import patch_match as pm

    inner = pm.patch_match

    def broken(draws, problem, opts, *a, **k):
        depth, normal, cost = inner(draws, problem, opts, *a, **k)
        if threading.current_thread().name == "shard-1":
            depth = depth * 0
        return depth, normal, cost
    monkeypatch.setattr(pm, "patch_match", broken)


def _swap_two_frames(monkeypatch):
    """The workspace load hands the first two frames each other's pixels,
    so each frame's map is made for, and filed under, the other."""
    from colmap_tpu_torch.controllers import dense_reconstruction as dr

    inner = dr._load_workspace

    def broken(*a, **k):
        model, images = inner(*a, **k)
        i, j = sorted(images)[:2]
        images[i], images[j] = images[j], images[i]
        return model, images
    monkeypatch.setattr(dr, "_load_workspace", broken)


def _swap_at_the_merge(monkeypatch):
    """The solver's maps are right, but cards 0 and 1 hand back their
    first depth maps each under the other's image id, so the merged maps,
    the job's result and the written files have the two swapped."""
    from colmap_tpu_torch.controllers import dense_reconstruction as dr

    inner = dr.run_shards

    def broken(mesh, fn):
        parts = inner(mesh, fn)
        (d0, _), (d1, _) = parts[:2]
        i, j = min(d0), min(d1)
        d0[j], d1[i] = d0.pop(i), d1.pop(j)
        return parts
    monkeypatch.setattr(dr, "run_shards", broken)


@pytest.mark.parametrize("fault", [_lose_a_card, _swap_two_frames,
                                   _swap_at_the_merge],
                         ids=["a_card_lost", "two_frames_swapped",
                              "two_maps_swapped_at_the_merge"])
def test_a_four_card_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    rc, res, err = _execute()
    assert rc == 0, err
    assert res["correct"] is False, res["checks"]
    worst = {k: v for k, v in res["checks"].items()
             if k.endswith("_worst_frame")}
    assert any(v["value"] > v["limit"] for v in worst.values()), worst


def _truth(n=4, H=24, W=32, seed=0):
    rng = np.random.default_rng(seed)
    depth = rng.uniform(1.0, 3.0, (n, H, W)).astype(np.float32)
    normal = np.zeros((n, H, W, 3), np.float32)
    normal[..., 2] = -1.0
    return {"images": rng.integers(0, 256, (n, H, W)).astype(np.uint8),
            "depth": depth, "normal": normal,
            "names": [f"f{k}.png" for k in range(n)]}


def test_the_reference_pools_as_the_plain_judge_and_finds_a_bad_frame():
    truth = _truth()
    good = {name: (truth["depth"][k] * 1.01, truth["normal"][k])
            for k, name in enumerate(truth["names"])}
    bad = dict(good)
    del bad["f2.png"]
    maps = {"photometric": good, "geometric": bad}
    got = reference.judge(maps, truth, 2, 0.02)
    want = plain.judge(maps, truth, 2, 0.02)
    for k, v in want.items():
        assert got[k] == v, k
    assert got["photometric_depth_err_p50_worst_frame"] == pytest.approx(
        0.01, rel=1e-5)
    # a quarter of the pixels lost: the pooled median passes, the worst
    # frame does not
    assert want["geometric_depth_err_p50"] < 0.1
    assert got["geometric_depth_err_p50_worst_frame"] == np.inf


def _span(name, sid, parent, start, end, thread=1, **attrs):
    return types.SimpleNamespace(name=name, id=sid, parent=parent,
                                 start=start, end=end, thread=thread,
                                 attrs=attrs)


def _read(monkeypatch, metric, spans):
    from colmap_tpu_torch.util import timer

    monkeypatch.setattr(timer, "last_job", lambda name: spans)
    return harness.metric_module(metric).read(None)


def test_card_wait_share_groups_by_card_then_by_thread(monkeypatch):
    # a pass of 100 ns on two cards: card 0 solves for 60, card 1 for 20
    with_cards = [
        _span("dense.solve", 2, 1, 0, 60, thread=7, card=0),
        _span("dense.solve", 3, 1, 50, 70, thread=8, card=1),
        _span("dense.pass", 1, 0, 0, 100, cards=2),
        _span("dense.patch_match_stereo", 0, None, 0, 110)]
    got = _read(monkeypatch, "dense.card_wait_share", with_cards)
    assert got == pytest.approx(100 * (0.4 + 0.8) / 2)
    # a pass of four cards of which two had no solve: they wait throughout
    with_cards[2].attrs["cards"] = 4
    got = _read(monkeypatch, "dense.card_wait_share", with_cards)
    assert got == pytest.approx(100 * (0.4 + 0.8 + 1 + 1) / 4)
    # a program without `card`: its shard threads tell the cards apart
    no_cards = [_span(s.name, s.id, s.parent, s.start, s.end, s.thread)
                for s in with_cards]
    got = _read(monkeypatch, "dense.card_wait_share", no_cards)
    assert got == pytest.approx(100 * (0.4 + 0.8) / 2)


def test_the_new_readers_read_nothing_without_what_they_read(monkeypatch):
    from colmap_tpu_torch.util import timer

    # a program without the dense spans
    assert _read(monkeypatch, "dense.card_wait_share",
                 [_span("dense.patch_match_stereo", 0, None, 0, 1)]) is None
    monkeypatch.delattr(timer, "last_job")
    assert harness.metric_module("dense.card_wait_share").read(None) is None
    # the harness's own tracer keeps no card; a card tracer with no op
    reader = harness.metric_module("idle_share.per_card")
    plain_tracer = harness.Tracer(True, lambda: None)
    plain_tracer.device_ops = [("k", 0.0, 10.0)]
    plain_tracer.done, plain_tracer.t0, plain_tracer.t1 = True, 0.0, 1e-4
    traffic = harness.traffic_module("dense_cards")
    card_tracer = traffic.CardTracer(True, lambda: None)
    card_tracer.done, card_tracer.t0, card_tracer.t1 = True, 0.0, 1e-4
    for tr in (plain_tracer, card_tracer, None):
        assert reader.read(types.SimpleNamespace(tracer=tr, chips=4)) is None
    # two cards of four busy over halves of a 100-us slice
    card_tracer.card_ops = [(0, "k", 0.0, 50.0), (1, "k", 50.0, 100.0),
                            (1, "k", 60.0, 70.0)]
    got = reader.read(types.SimpleNamespace(tracer=card_tracer, chips=4))
    assert got == pytest.approx(100 * (0.5 + 0.5 + 1 + 1) / 4)


def test_the_judge_reads_the_maps_back_as_the_program_writes_them(tmp_path):
    from colmap_tpu_torch.mvs import depth_map as dm

    traffic = harness.traffic_module("dense_cards")
    for kind in ("depth_maps", "normal_maps"):
        (tmp_path / "stereo" / kind).mkdir(parents=True)
    rng = np.random.default_rng(5)
    depth = rng.uniform(1, 3, (7, 12)).astype(np.float32)
    normal = rng.normal(size=(7, 12, 3)).astype(np.float32)
    # bytes equal to "&" in the data must not cut it short
    depth[0, 0] = np.frombuffer(b"&&&&", np.float32)[0]
    ws = str(tmp_path)
    dm.DepthMap(depth).write(
        f"{ws}/stereo/depth_maps/a.png.geometric.bin")
    dm.NormalMap(normal).write(
        f"{ws}/stereo/normal_maps/a.png.geometric.bin")
    dm.DepthMap(depth).write(
        f"{ws}/stereo/depth_maps/b.png.geometric.bin")
    got = traffic.written_maps(ws, ["a.png", "b.png", "c.png"])
    assert list(got) == ["a.png"]  # b has no normal map, c no file
    np.testing.assert_array_equal(got["a.png"][0], depth)
    np.testing.assert_array_equal(got["a.png"][1], normal)
    traffic._clear_maps(ws)
    assert traffic.written_maps(ws, ["a.png", "b.png"]) == {}


@pytest.mark.parametrize("shape", [(480, 640), (97, 61), (7, 12)])
def test_the_reference_masks_a_frame_as_the_plain_judge(shape):
    image = np.random.default_rng(3).integers(0, 256, shape).astype(
        np.uint8)
    image[:, : shape[1] // 3] = 128  # a flat part: both sides of the limit
    want = plain.textured(image[None], 5, 0.02)[0]
    np.testing.assert_array_equal(reference.mask(image, 5, 0.02), want)
