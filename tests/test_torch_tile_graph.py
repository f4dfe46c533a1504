"""The tile renderer's CUDA graph (`train/loop.py:make_image_renderer`).

On the CPU:
- the renderer is the plain tile loop: padded, tiled, concatenated and
  stripped, bit-equal to a loop written here, and it counts no tile;
- with the card's three calls stubbed (`loop._graphs_on`, `_warm`,
  `_capture`: a stub graph reruns the captured call into its static
  outputs), the graph path of a toy tile and of the five CLI render paths
  at tiny sizes renders the eager path's bits, with the same spans and
  kernel launches a view; tiles are counted by how they ran; another pack
  captures anew and never replays the old graph; weights changed in place
  show in the next view; a capture that raises warns once and leaves the
  key's tiles eager.
On the card (`cuda`): the five CLI render paths replayed from a graph
against their eager views (bits, launches a view); a 320x240 view in
300 tiles (the render cell's tiling): 600 / 300 spans a view and the
tiles' counts; another scene, weights changed in place, a capture that
waits for the stream; the profiler's kernels of a replayed view.
"""

import functools
import warnings

import numpy as np
import pytest
import torch

from neo360_tpu_torch import cli
from neo360_tpu_torch.config import preset
from neo360_tpu_torch.data.fixtures import MemoryScenes
from neo360_tpu_torch.models import mipnerf360
from neo360_tpu_torch.ops import kernels
from neo360_tpu_torch.train import loop, profiling
from neo360_tpu_torch.train.profiling import span

WH = (40, 30)
CHUNK = 256
# the five render paths of cli.make_render_fn at tiny sizes
TINY = {
    "vanilla": dict(num_coarse_samples=8, num_fine_samples=8),
    "mipnerf360": dict(num_prop_samples=8, num_fine_samples=4),
    "pixelnerf": dict(num_coarse_samples=8, num_fine_samples=8),
    "neo360": dict(grid_size=(8, 8, 8), encoder_width=64,
                   num_coarse_samples=8, num_fine_samples=6),
    "neo360_fast": dict(bf16=False, grid_size=(8, 8, 4), encoder_width=64,
                        lift_dim=32, num_prop_samples=8, num_fine_samples=6),
}
MIP_WIDTHS = dict(nerf_netwidth=32, prop_netdepth=2, prop_netwidth=32)


def _plain(fn, pack, rays, chunk):
    """The tile loop, written out: pad by repeating the last ray, render
    the tiles in order, concatenate, strip."""
    n = next(iter(rays.values())).shape[0]
    pad = -n % chunk
    padded = {k: torch.cat([v] + [v[-1:]] * pad) for k, v in rays.items()}
    outs = [fn(pack, {k: v[i:i + chunk] for k, v in padded.items()})
            for i in range(0, n + pad, chunk)]
    return {k: torch.cat([o[k] for o in outs])[:n] for k in outs[0]}


def _toy(weight):
    """A tile function with nested spans and two counted "launches": it
    reads the pack, its rays and `weight` (a tensor the caller may change
    in place)."""
    def fn(pack, rays):
        with span("model.rays"):
            x = rays["rays_o"] * pack["scale"] + rays["rays_d"]
        for _ in range(2):
            with span("model.mlp"):
                with span("model.sample"):
                    x = torch.tanh(x @ weight)
                kernels.launches["composite_nerfpp_fwd"] += 1
        return {"rgb": torch.sigmoid(x), "depth": x.sum(-1)}
    return fn


def _rays(n, seed=0, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    return {k: torch.randn(n, 3, generator=g).to(device)
            for k in ("rays_o", "rays_d")}


def _view_counts(got):
    """Per item: {span: (count, timed)} and its tiles by how they ran."""
    return [({n: (r["count"], r["timed"]) for n, r in it["spans"].items()},
             it["graphs"]) for it in got]


@pytest.mark.parametrize("n", [1, 256, 700, 2 * 256 * 16 + 3])
def test_on_the_cpu_the_renderer_is_the_plain_tile_loop(n):
    profiling.clear()
    w = torch.randn(3, 3, generator=torch.Generator().manual_seed(1))
    fn, pack = _toy(w), {"scale": torch.tensor(0.5)}
    rays = _rays(n)
    got = loop.make_image_renderer(fn, 256)(pack, rays)
    want = _plain(fn, pack, rays, 256)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape[0] == n and torch.equal(got[k], want[k])
    tiles = -(-n // 256)
    (table, graphs), = _view_counts(profiling.items())
    assert table["render.tile"] == (tiles, 0)
    assert table["render.assemble"] == (2, 0)
    assert graphs == {"captured": 0, "replayed": 0, "eager": 0}


class _Graph:
    """A stub CUDA graph: a replay reruns the captured call and copies its
    outputs into the static ones."""

    def __init__(self, fn, out):
        self.fn, self.out = fn, out
        self.replays = self.resets = 0

    def replay(self):
        self.replays += 1
        for k, v in self.fn().items():
            self.out[k].copy_(v)

    def reset(self):
        self.resets += 1


@pytest.fixture
def stub_graphs(monkeypatch):
    """The graph path on the CPU; yields the graphs captured."""
    made = []

    def capture(fn, side):
        assert side == "side"
        out = fn()
        made.append(_Graph(fn, out))
        return made[-1], out

    monkeypatch.setattr(loop, "_graphs_on", lambda device: True)
    monkeypatch.setattr(loop, "_warm", lambda fn, device: (fn(), "side"))
    monkeypatch.setattr(loop, "_capture", capture)
    profiling.clear()
    yield made
    profiling.clear()


def _launched(fn):
    before = dict(kernels.launches)
    out = fn()
    return out, {k: n - before[k] for k, n in kernels.launches.items()
                 if n != before[k]}


def test_a_replayed_view_is_the_eager_view(stub_graphs, monkeypatch):
    """Bits, spans, launches a view and the tiles' counts, the graph path
    against the eager one: 40 tiles, 3 marked; the first unmarked tile is
    captured in the first view only."""
    w = torch.randn(3, 3, generator=torch.Generator().manual_seed(1))
    fn, pack = _toy(w), {"scale": torch.tensor(0.5)}
    rays = _rays(40 * 256 - 5)
    render = loop.make_image_renderer(fn, 256)
    views = [_launched(lambda: render(pack, rays)) for _ in range(2)]
    graph_items = _view_counts(profiling.items())
    assert len(stub_graphs) == 1 and stub_graphs[0].replays == 36 + 37
    profiling.clear()
    monkeypatch.setattr(loop, "_graphs_on", lambda device: False)
    eager, eager_launches = _launched(lambda: render(pack, rays))
    (eager_table, eager_graphs), = _view_counts(profiling.items())
    for out, launched in views:
        assert launched == eager_launches == {"composite_nerfpp_fwd": 80}
        for k in eager:
            assert torch.equal(out[k], eager[k])
    assert eager_table["model.sample"] == (80, 0)
    assert eager_graphs == {"captured": 0, "replayed": 0, "eager": 0}
    assert [t for t, _ in graph_items] == [eager_table, eager_table]
    assert [g for _, g in graph_items] == [
        {"captured": 1, "replayed": 36, "eager": 3},
        {"captured": 0, "replayed": 37, "eager": 3}]


def test_another_pack_captures_anew(stub_graphs):
    """A pack with other tensors (of the same shapes) captures a graph of
    its own and the old one is reset; the same pack again replays."""
    w = torch.randn(3, 3, generator=torch.Generator().manual_seed(1))
    fn = _toy(w)
    packs = [{"scale": torch.tensor(s)} for s in (0.5, 2.0)]
    rays = _rays(5 * 256)
    render = loop.make_image_renderer(fn, 256)
    for pack in packs + packs[1:]:
        got = render(pack, rays)
        want = _plain(fn, pack, rays, 256)
        for k in want:
            assert torch.equal(got[k], want[k])
    assert len(stub_graphs) == 2
    assert [g.resets for g in stub_graphs] == [1, 0]
    assert [g.replays for g in stub_graphs] == [3, 3 + 4]
    assert [it["graphs"]["captured"] for it in profiling.items()] == [1, 1, 0]


def test_weights_changed_in_place_show_in_the_next_view(stub_graphs):
    w = torch.randn(3, 3, generator=torch.Generator().manual_seed(1))
    fn, pack = _toy(w), {"scale": torch.tensor(0.5)}
    rays = _rays(3 * 256)
    render = loop.make_image_renderer(fn, 256)
    first = render(pack, rays)
    w.mul_(-0.5)
    second = render(pack, rays)
    want = _plain(fn, pack, rays, 256)
    assert not torch.equal(first["rgb"], second["rgb"])
    for k in want:
        assert torch.equal(second[k], want[k])
    assert len(stub_graphs) == 1


def test_a_capture_that_raises_leaves_the_key_eager(stub_graphs,
                                                    monkeypatch):
    def refuse(fn, side):
        fn()
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")

    monkeypatch.setattr(loop, "_capture", refuse)
    w = torch.randn(3, 3, generator=torch.Generator().manual_seed(1))
    fn, pack = _toy(w), {"scale": torch.tensor(0.5)}
    rays = _rays(20 * 256)
    render = loop.make_image_renderer(fn, 256)
    with pytest.warns(RuntimeWarning, match="could not be captured"):
        first, launched = _launched(lambda: render(pack, rays))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        second = render(pack, rays)
    want = _plain(fn, pack, rays, 256)
    for k in want:
        assert torch.equal(first[k], want[k])
        assert torch.equal(second[k], want[k])
    assert launched == {"composite_nerfpp_fwd": 40}
    assert [it["graphs"] for it in profiling.items()] == 2 * [
        {"captured": 0, "replayed": 0, "eager": 20}]
    assert [it["spans"]["model.sample"]["count"]
            for it in profiling.items()] == [40, 40]


@pytest.fixture
def tiny_mip(monkeypatch):
    model = mipnerf360.MipNeRF360

    class Tiny(model):
        __init__ = functools.partialmethod(model.__init__, **MIP_WIDTHS)

    monkeypatch.setattr(mipnerf360, "MipNeRF360", Tiny)


def _render_path(exp_type, device, scenes=1):
    """A tiny model of `exp_type`, its cli.make_render_fn on `device`, and
    one test view of each of `scenes` fixture scenes (MipNeRF-360's with
    pixel radii)."""
    cfg = preset(exp_type, seed=0, img_wh=WH, chunk=CHUNK,
                 **TINY[exp_type])
    model = cli.build_model(cfg, device)
    data = MemoryScenes(scenes, WH)
    samples = [dict(data.sample_test(i, 0), scene_key=i)
               for i in range(scenes)]
    for s in samples:
        s["radii"] = np.full((WH[0] * WH[1], 1), 2e-3, np.float32)
    return model, cli.make_render_fn(cfg, model, device), samples


@pytest.mark.parametrize("exp_type", sorted(TINY))
def test_the_cli_render_paths_replay_the_eager_bits(exp_type, stub_graphs,
                                                    monkeypatch, tiny_mip):
    torch.manual_seed(0)
    _, render, (sample,) = _render_path(exp_type, "cpu")
    graph = render(sample)
    monkeypatch.setattr(loop, "_graphs_on", lambda device: False)
    eager = render(sample)
    assert set(graph) == set(eager)
    for k in eager:
        assert torch.equal(graph[k], eager[k]), k
    assert len(stub_graphs) == 1 and stub_graphs[0].replays == 3
    graph_item, eager_item = profiling.items()
    assert graph_item["graphs"] == {"captured": 1, "replayed": 3,
                                    "eager": 1}
    assert _view_counts([graph_item])[0][0] == \
        _view_counts([eager_item])[0][0]


# ------------------------------------------------------------- the card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _eager(monkeypatch, fn):
    """fn() with the graph path off, then on again."""
    with monkeypatch.context() as m:
        m.setattr(loop, "_graphs_on", lambda device: False)
        return fn()


def _close(got, want):
    """Bit-equal expected; fails above 1e-6 of the largest entry."""
    for k in want:
        g, w = got[k].float(), want[k].float()
        scale = float(w.abs().max()) or 1.0
        assert float((g - w).abs().max()) <= 1e-6 * scale, k


@pytest.mark.cuda
@pytest.mark.parametrize("exp_type", sorted(TINY))
def test_card_graph_views_equal_eager_views(exp_type, monkeypatch,
                                            tiny_mip):
    """Two views through the graph (the first captures) against an eager
    view: values and kernel launches a view."""
    dev = _card()
    _, render, (sample,) = _render_path(exp_type, dev)
    _eager(monkeypatch, lambda: render(sample))    # encodes the scene
    profiling.clear()
    eager, eager_launches = _launched(
        lambda: _eager(monkeypatch, lambda: render(sample)))
    views = [_launched(lambda: render(sample)) for _ in range(2)]
    torch.cuda.synchronize()
    for out, launched in views:
        _close(out, eager)
        assert launched == eager_launches
    got = [it["graphs"] for it in profiling.items()]
    assert got[1:] == [{"captured": 1, "replayed": 3, "eager": 1},
                       {"captured": 0, "replayed": 4, "eager": 1}], got


@pytest.mark.cuda
def test_card_a_cell_sized_view_keeps_its_spans_and_counts(monkeypatch):
    """A 320x240 view in 256-ray tiles, the render cell's tiling: 300
    tiles, 19 marked; every view counts 300 tiles and 600 of each level's
    spans, 19 / 38 of them timed; the first view captures one tile."""
    dev = _card()
    cfg = preset("neo360", seed=0, img_wh=(320, 240), chunk=256,
                 **TINY["neo360"])
    model = cli.build_model(cfg, dev)
    sample = dict(MemoryScenes(1, (320, 240)).sample_test(0, 0),
                  scene_key=0)
    render = cli.make_render_fn(cfg, model, dev)
    eager = _eager(monkeypatch, lambda: render(sample))
    profiling.clear()
    for _ in range(2):
        _close(render(sample), eager)
    got = profiling.items()
    assert [it["graphs"] for it in got] == [
        {"captured": 1, "replayed": 280, "eager": 19},
        {"captured": 0, "replayed": 281, "eager": 19}]
    for it in got:
        spans = it["spans"]
        assert (spans["render.tile"]["count"],
                spans["render.tile"]["timed"]) == (300, 19)
        assert spans["model.rays"]["count"] == 300
        for name in ("model.sample", "model.gather", "model.mlp",
                     "model.composite"):
            assert (spans[name]["count"], spans[name]["timed"]) == (600, 38)
            assert spans[name]["device_ms"] > 0


@pytest.mark.cuda
def test_card_another_scene_captures_anew(monkeypatch):
    dev = _card()
    profiling.clear()
    _, render, samples = _render_path("neo360", dev, scenes=2)
    eager = [_eager(monkeypatch, lambda: render(s)) for s in samples]
    for s, want in zip(samples + samples, eager + eager):
        _close(render(s), want)
    assert not torch.equal(eager[0]["rgb"], eager[1]["rgb"])
    assert [it["graphs"]["captured"] for it in profiling.items()] == \
        [0, 0, 1, 1, 1, 1]


@pytest.mark.cuda
def test_card_weights_changed_in_place_show_in_the_next_view(monkeypatch):
    dev = _card()
    model, render, (sample,) = _render_path("neo360", dev)
    first = render(sample)
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(0.9)
    second = render(sample)
    want = _eager(monkeypatch, lambda: render(sample))
    assert not torch.equal(first["rgb"], second["rgb"])
    _close(second, want)


@pytest.mark.cuda
def test_card_a_capture_that_waits_for_the_stream_falls_back(monkeypatch):
    """A tile that reads a value on the host cannot be captured: the
    renderer warns, renders the key's tiles eagerly and stays usable."""
    dev = _card()
    profiling.clear()
    w = torch.randn(3, 3, generator=torch.Generator().manual_seed(1)).to(dev)
    toy = _toy(w)

    def syncing(pack, rays):
        out = toy(pack, rays)
        return dict(out, depth=out["depth"] * float(out["rgb"].mean() > 0))

    pack = {"scale": torch.tensor(0.5, device=dev)}
    rays = _rays(8 * 256, device=dev)
    render = loop.make_image_renderer(syncing, 256)
    with pytest.warns(RuntimeWarning, match="could not be captured"):
        got = render(pack, rays)
    again = render(pack, rays)
    want = _plain(syncing, pack, rays, 256)
    _close(got, want)
    _close(again, want)
    assert [it["graphs"] for it in profiling.items()] == 2 * [
        {"captured": 0, "replayed": 0, "eager": 8}]
    fine = loop.make_image_renderer(toy, 256)(pack, rays)
    _close(fine, _plain(toy, pack, rays, 256))
    assert profiling.items()[-1]["graphs"]["replayed"] == 6


@pytest.mark.cuda
def test_card_the_profiler_records_a_replayed_views_kernels(monkeypatch):
    """benchmark/trace.py's reading of a replayed view: every kernel of the
    eager view as often, but the concatenation of the tiles' outputs (the
    graph path copies them into the view's outputs instead) and the
    copies inside a tile, which a graph runs as kernels (`memcpy*`) where
    the eager tile's are copies."""
    from benchmark import trace
    dev = _card()
    _, render, (sample,) = _render_path("neo360", dev)
    render(sample)
    sync = torch.cuda.synchronize
    graph = trace.profile(lambda: render(sample), sync)["kernels"]
    eager = _eager(monkeypatch, lambda: trace.profile(
        lambda: render(sample), sync))["kernels"]
    count = lambda ks: {k: v["launches"] for k, v in ks.items()
                        if "CatArrayBatchedCopy" not in k
                        and not k.startswith("memcpy")}
    got, want = count(graph), count(eager)
    assert got == want, {k: (got.get(k), want.get(k))
                         for k in set(got) | set(want)
                         if got.get(k) != want.get(k)}
    assert sum(got.values()) > 100
