"""The port's span recorder (`core/spans.py:item`, `span`, re-exported by
`train/profiling.py`) and the benchmark's readers of it
(`benchmark/spans.py`, the `*_device_ms.*` metrics).

On the CPU:
- nesting: each span's item, its host and self host ms, on a stubbed
  clock (exact); a span outside an item records nothing; another
  thread's items are its own;
- device markers on a stubbed `torch.cuda` (events stamped in the order
  they are recorded): shared boundaries, a span with `device=False` and
  the spans inside it unmarked, the scaling of the timed spans, events
  back to the pool, the oldest item read by the time the item after next
  closes, a failing marker giving None, an exception closing the item;
- the last MAX_ITEMS items are kept;
- `record_function` is called only while the profiler records;
- the readers' window: the item spans of the cell's kind before the
  profiled one, per training step, on a synthetic record;
- `run.run_cell` with `--trace 1` on the tiny cells (and the production
  preset's stage cell, which opens no item): every phase's spans
  recorded, the cell listing the metric of each recorded span and no
  other, the six metrics absent (no device markers on the CPU),
  nothing raised; a vanilla NeRF view's `model.sample`, `.mlp` and
  `.composite` twice a tile, inside `render.tile`;
- a MipNeRF-360 step (its cell at its adapter's tiny sizes): each level's
  `model.sample`, `.ipe`, `.mlp` and `.composite`, and
  `model.regularizers` once, all inside `train.loss`; the readers of
  `sample_device_ms.train` and `ipe_device_ms.train` on a synthetic
  record.
On the card (`cuda`): the same runs give the six metrics (a vanilla
view the sample and MLP ones); with every tile marked, each item's
spans tile its device timeline; by default one
tile in `loop.MARKED_TILES` is timed; a MipNeRF-360 step launches E and
E' three times each and gives the two new metrics.
"""

import threading

import pytest
import torch

from benchmark import run, spans
from benchmark.tests.support import STAGE_CELL, adapter, with_production
from neo360_tpu_torch.core import spans as core_spans
from neo360_tpu_torch.ops import kernels
from neo360_tpu_torch.train import loop, profiling
from neo360_tpu_torch.train.profiling import item, noting, span

METRICS = {"step": ("encoder_device_ms.train", "backward_device_ms.train",
                    "update_device_ms.train"),
           "view": ("sample_device_ms.render", "gather_device_ms.render",
                    "mlp_device_ms.render")}
ALL_METRICS = METRICS["step"] + METRICS["view"]
SPAN = {"encoder_device_ms.train": "model.encode",
        "backward_device_ms.train": "train.backward",
        "update_device_ms.train": "train.update",
        "sample_device_ms.render": "model.sample",
        "gather_device_ms.render": "model.gather",
        "mlp_device_ms.render": "model.mlp"}
VANILLA_CELL = "vanilla.render_view"
CELLS = ["neo360.train_step", "neo360.render_view", STAGE_CELL,
         VANILLA_CELL]
ITEM = {"neo360.train_step": "train.step", STAGE_CELL: "train.stage",
        "neo360.render_view": "render.view", VANILLA_CELL: "render.view"}
LEVEL_SPANS = ("model.sample", "model.mlp", "model.composite")


def _metrics(reg, cell):
    """The span metrics that BENCHMARK.json lists for the cell."""
    kind = "view" if "render" in cell else "step"
    listed = {m["name"] for m in reg.metrics(cell, True)}
    return tuple(m for m in METRICS[kind] if m in listed)


class _Clock:
    """perf_counter_ns reading 0, 10, 20, ... ns, one step a call."""

    def __init__(self):
        self.t = -10

    def __call__(self):
        self.t += 10
        return self.t


@pytest.fixture
def recorder(monkeypatch):
    profiling.clear()
    monkeypatch.setattr(core_spans, "_now", _Clock())
    yield
    profiling.clear()


class _Device:
    """A stubbed card: the k-th marker recorded stamps k ms; `fail_at`
    makes that record raise; `ready` is what a query answers."""

    def __init__(self):
        self.records = 0
        self.made = 0
        self.synced = 0
        self.fail_at = None
        self.ready = True
        dev = self

        class Event:
            def __init__(self, enable_timing=False):
                assert enable_timing
                dev.made += 1
                self.t = None

            def record(self, stream=None):
                assert stream == "stream"
                if dev.records == dev.fail_at:
                    raise RuntimeError("marker")
                self.t = dev.records
                dev.records += 1

            def query(self):
                return dev.ready

            def synchronize(self):
                dev.synced += 1

            def elapsed_time(self, end):
                return float(end.t - self.t)

        self.Event = Event


@pytest.fixture
def device(recorder, monkeypatch):
    dev = _Device()
    monkeypatch.setattr(core_spans, "_pool", [])
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: "stream")
    monkeypatch.setattr(torch.cuda, "Event", dev.Event)
    return dev


def test_nesting_parent_item_and_self_time(recorder):
    with span("alone"):             # outside an item: nothing
        pass
    with item("step"):              # t 0 ... 70
        with span("loss"):          # 10 ... 40
            with span("mlp"):       # 20 ... 30
                pass
        with span("mlp"):           # 50 ... 60
            pass
    with item("view"):              # a new item
        with item("inner"):         # inside an item: a span of it
            pass
    got = profiling.items()
    assert [it["name"] for it in got] == ["step", "view"]
    assert got[1]["id"] == got[0]["id"] + 1
    table = got[0]["spans"]
    assert set(table) == {"step", "loss", "mlp"}
    assert set(got[1]["spans"]) == {"view", "inner"}
    ms = lambda ns: pytest.approx(ns * 1e-6)
    assert table["step"]["count"] == 1 and table["mlp"]["count"] == 2
    assert table["step"]["host_ms"] == ms(70)
    assert table["step"]["self_host_ms"] == ms(70 - 30 - 10)
    assert table["loss"]["host_ms"] == ms(30)
    assert table["loss"]["self_host_ms"] == ms(30 - 10)
    assert table["mlp"]["host_ms"] == table["mlp"]["self_host_ms"] == ms(20)
    for row in table.values():      # no device markers on the CPU
        assert row["device_ms"] is None and row["self_device_ms"] is None
        assert row["timed"] == 0


def test_each_thread_has_its_own_stack(recorder):
    with item("outer"):
        t = threading.Thread(target=lambda: item("other").__enter__()
                             .__exit__(None, None, None))
        t.start()
        t.join()
        with span("inner"):
            pass
    got = profiling.items()
    assert [it["name"] for it in got] == ["other", "outer"]
    assert set(got[1]["spans"]) == {"outer", "inner"}
    assert set(got[0]["spans"]) == {"other"}


def test_threads_recording_at_once_lose_no_item():
    """Eight threads closing 30 items each with the switch interval
    shortened: every item kept whole, every id once."""
    import sys
    profiling.clear()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work(k):
        for i in range(30):
            with item(f"t{k}"):
                for _ in range(3):
                    with span("inner"):
                        pass

    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    got = profiling.items()
    assert len(got) == 240 and len({it["id"] for it in got}) == 240
    for k in range(8):
        mine = [it for it in got if it["name"] == f"t{k}"]
        assert len(mine) == 30
        assert all(it["spans"]["inner"]["count"] == 3
                   and set(it["spans"]) == {f"t{k}", "inner"}
                   for it in mine)
    profiling.clear()


def test_disabled_records_nothing(recorder):
    profiling.enable(False)
    try:
        with item("step"):
            with span("loss"):
                pass
    finally:
        profiling.enable(True)
    assert profiling.items() == []


def _marked_view():
    with item("view"):                          # marker 0
        with span("a"):                         # 1 ... 2
            pass
        for j in range(4):
            with span("tile", j % 2 == 0):      # tile 0: 2 (shared) ... 5
                with span("m"):                 # 3 ... 4; tile 2: 6 ... 9
                    pass                        # (7 ... 8); 1 and 3: none
        with span("a"):                         # 10 ... 11
            pass
    # the view ends at 12


def test_markers_shared_unmarked_subtrees_and_scaling(device):
    _marked_view()
    assert device.records == device.made == 13
    t = profiling.items()[-1]["spans"]
    assert t["view"]["device_ms"] == 12 and t["view"]["timed"] == 1
    # the view's tiles were not all timed: no self device time
    assert t["view"]["self_device_ms"] is None
    assert t["a"]["device_ms"] == 2 and t["a"]["self_device_ms"] == 2
    # two of four tiles timed (3 ms each): scaled to four
    assert t["tile"]["count"] == 4 and t["tile"]["timed"] == 2
    assert t["tile"]["device_ms"] == 12
    assert t["tile"]["self_device_ms"] == 2 * (3 - 1) * 2
    assert t["m"]["count"] == 4 and t["m"]["timed"] == 2
    assert t["m"]["device_ms"] == 4
    # read: the events are back in the pool and serve the next item
    _marked_view()
    assert device.made == 13 and device.records == 26
    assert profiling.items()[-1]["spans"] == t


def test_an_item_is_read_by_the_time_the_item_after_next_closes(device):
    device.ready = False            # the card never seems done
    for i in range(3):
        with item(f"step{i}"):
            with span("loss"):
                pass
    assert device.synced == 1       # the first, waited for at the third
    assert [it.name for it in core_spans._done] == ["step0"]
    assert len(core_spans._pending) == 2
    got = profiling.items()         # reads the rest
    assert [it["name"] for it in got] == ["step0", "step1", "step2"]
    assert all(it["spans"]["loss"]["device_ms"] == 1 for it in got)


def test_a_failing_marker_leaves_the_item_without_device_times(device):
    device.fail_at = 2
    with pytest.warns(RuntimeWarning, match="device times read None"):
        _marked_view()              # raises nothing
    t = profiling.items()[-1]["spans"]
    assert t["tile"]["count"] == 4 and t["m"]["count"] == 4
    assert all(row["device_ms"] is None and row["timed"] == 0
               and row["host_ms"] > 0 for row in t.values())
    device.fail_at = None
    _marked_view()
    assert profiling.items()[-1]["spans"]["view"]["device_ms"] == 12


def test_an_exception_closes_the_item(device):
    with pytest.raises(ValueError):
        with item("step"):
            with span("loss"):
                with span("mlp"):
                    raise ValueError("inside")
    with item("next"):
        with span("loss"):
            pass
    got = profiling.items()
    assert [it["name"] for it in got] == ["step", "next"]
    assert set(got[0]["spans"]) == {"step", "loss", "mlp"}
    assert set(got[1]["spans"]) == {"next", "loss"}
    assert got[0]["spans"]["step"]["device_ms"] is not None


def _tile():
    """A render tile's spans: a marker-free leaf, then two nested levels."""
    with span("model.rays"):
        pass
    for _ in range(2):
        with span("model.mlp"):
            with span("model.sample"):
                pass
            with span("model.gather", device=False):
                with span("inner"):
                    pass


def _view(replayed: bool):
    """An item of four tiles, the first marked: the other three run, or
    are credited from the spans one captured tile noted."""
    noted = None
    with item("view"):
        for j in range(4):
            with span("tile", j == 0):
                if j == 0 or not replayed:
                    _tile()
                elif noted is None:
                    with noting() as noted:
                        _tile()
                    profiling.credit(noted)
                else:
                    profiling.credit(noted)
    return noted


def test_noting_keeps_the_names_and_nesting_and_records_nothing(device):
    with item("view"):
        with noting() as noted:
            _tile()
            with item("nested item"):   # a span of the noted region
                pass
            assert noted == []          # filled when the block closes
    assert noted == ["model.rays", None] + 2 * [
        "model.mlp", "model.sample", None, "model.gather", "inner", None,
        None, None] + ["nested item", None]
    assert device.records == 2          # the view's markers only
    assert set(profiling.items()[-1]["spans"]) == {"view"}
    with noting() as alone:             # outside an item: noted all the same
        _tile()
    assert alone == noted[:-2]
    assert profiling.items()[-1]["spans"] == profiling.items()[0]["spans"]


def test_credited_spans_count_as_run_untimed(device):
    """Crediting a replayed tile's noted spans gives the item the span
    names, counts, timed counts and device figures of running the tile,
    and no host time: the replay's host time stays in its tile span."""
    _view(replayed=False)
    ran = profiling.items()[-1]["spans"]
    markers = device.records
    _view(replayed=True)
    credited = profiling.items()[-1]["spans"]
    assert device.records - markers == markers
    assert set(credited) == set(ran)
    for name, row in ran.items():
        for field in ("count", "timed", "device_ms", "self_device_ms"):
            assert credited[name][field] == row[field], (name, field)
    assert credited["model.sample"]["count"] == 8
    assert credited["model.sample"]["timed"] == 2
    assert credited["inner"]["timed"] == 0
    # host time: the marked tile's and the noted tile's spans only
    for name in ("model.rays", "model.mlp", "model.sample", "inner"):
        assert 0 < credited[name]["host_ms"] < ran[name]["host_ms"]
    assert credited["model.mlp"]["self_host_ms"] < \
        ran["model.mlp"]["self_host_ms"]


def test_credit_outside_an_item_or_of_nothing_records_nothing(recorder):
    with noting() as noted:
        _tile()
    profiling.credit(noted)
    with item("view"):
        profiling.credit([])
    assert [set(it["spans"]) for it in profiling.items()] == [{"view"}]


def test_tiles_by_how_they_ran_per_item(recorder):
    """Each item carries the tiles counted while it was open, by how they
    ran (`graphs`), as it carries its constants."""
    profiling.graphs["eager"] += 5         # outside any item: no item's
    with item("view"):
        profiling.graphs["captured"] += 1
        profiling.graphs["replayed"] += 3
        profiling.graphs["eager"] += 2
    with item("view"):
        profiling.graphs["replayed"] += 4
    got = [it["graphs"] for it in profiling.items()]
    assert got == [{"captured": 1, "replayed": 3, "eager": 2},
                   {"captured": 0, "replayed": 4, "eager": 0}]


def test_the_last_max_items_are_kept(recorder):
    n = profiling.MAX_ITEMS + 44
    for i in range(n):
        with item(f"item{i}"):
            with span("inner"):
                pass
    got = profiling.items()
    assert len(got) == profiling.MAX_ITEMS == 256
    assert [it["name"] for it in got] == [f"item{i}"
                                          for i in range(44, n)]
    ids = [it["id"] for it in got]
    assert ids == list(range(ids[0], ids[0] + 256))


def test_record_function_only_under_the_profiler(monkeypatch):
    calls = []
    real = torch.profiler.record_function

    def counting(name, *args):
        calls.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    with item("a"):
        with span("b"):
            pass
    assert calls == []
    with torch.profiler.profile() as prof:
        with item("a"):
            with span("b"):
                torch.ones(8) + 1
        with span("c"):             # outside an item: still in the trace
            pass
    assert calls == ["a", "b", "c"]
    names = {e.key for e in prof.key_averages()}
    assert {"a", "b", "c"} <= names
    with item("a"):
        pass
    assert calls == ["a", "b", "c"]


def _item(name, phases, i):
    return {"id": i, "name": name,
            "spans": {name: {"count": 1, "host_ms": 10.0 + i,
                             "self_host_ms": 0.5, "device_ms": 9.0 + i,
                             "self_device_ms": 0.25, "timed": 1},
                      **{p: {"count": 4, "host_ms": ms, "self_host_ms": ms,
                             "device_ms": ms * 2, "self_device_ms": ms * 2,
                             "timed": 2}
                         for p, ms in phases}}}


def test_the_readers_window_and_per_step_division(monkeypatch, capsys):
    """Three warm-up stages, another kind's item, five window stages and
    one profiled stage: the window is the five, a figure is their median
    over 4 steps a stage."""
    records = [_item("train.stage", [("train.backward", 100.0)], i)
               for i in range(3)]
    records.append(_item("render.view", [], 3))
    window = [(1.0, 7.0), (2.0, 9.0), (3.0, 8.0), (4.0, 6.0), (5.0, 5.0)]
    records += [_item("train.stage", [("train.backward", b),
                                      ("train.update", u)], 4 + i)
                for i, (b, u) in enumerate(window)]
    records.append(_item("train.stage", [("train.backward", 500.0)], 9))
    monkeypatch.setattr(profiling, "items", lambda: records)
    ctx = {"kind": "stage", "items": 5, "trace": {"busy_s": 1.0},
           "steps_per_item": 4, "window_s": 0.05}
    assert [r["id"] for r in spans.window_items(records, ctx)] == \
        [4, 5, 6, 7, 8]
    # medians of 2 x (1..5) and 2 x (5..9), over 4 steps
    assert spans.phase_ms(ctx, "train.backward") == pytest.approx(6.0 / 4)
    assert spans.phase_ms(ctx, "train.update") == pytest.approx(14.0 / 4)
    assert spans.phase_ms(ctx, "model.encode") is None
    err = capsys.readouterr().err.splitlines()
    assert err[0].startswith("[spans] 5 train.stage items, 10.0000 ms")
    assert err[0].endswith("self_device_ms timed")
    assert "[spans] train.backward 4.0000 3.0000 3.0000 6.0000 6.0000 " \
        "2.0000" in err
    spans.phase_ms(ctx, "train.update")
    assert capsys.readouterr().err == ""       # logged once a run
    # without a profiled item the window is the last five of the kind
    ctx = {"kind": "stage", "items": 5, "trace": None, "steps_per_item": 1,
           "window_s": 0.05}
    assert [r["id"] for r in spans.window_items(records, ctx)] == \
        [5, 6, 7, 8, 9]
    assert spans.phase_ms(ctx, "train.backward") == pytest.approx(8.0)
    # a program without the recorder: no figure, nothing raised
    monkeypatch.delattr(profiling, "items")
    ctx = {"kind": "view", "items": 2, "trace": None, "steps_per_item": 1,
           "window_s": 1.0}
    assert spans.phase_ms(ctx, "model.mlp") is None
    assert spans.table(ctx) == {}


def _run_tiny(monkeypatch, tmp_path, cell, device):
    # the test process holds JAX for the JAX package's own tests; a
    # benchmark process refuses it (test_bench_harness.py)
    monkeypatch.setattr(run, "forbidden_modules", lambda: [])
    reg = with_production(tmp_path)
    config = reg.config(reg.workload(cell)["config"])
    profiling.clear()
    with adapter(reg, cell).tiny(config) as over:
        res = run.run_cell(reg, cell, 3_000_000_019, 0.3, True, device,
                           over)
    return reg, res


@pytest.mark.parametrize("cell", CELLS)
def test_run_cell_records_every_phase_on_the_cpu(cell, monkeypatch,
                                                 tmp_path, capsys):
    reg, res = _run_tiny(monkeypatch, tmp_path, cell, torch.device("cpu"))
    kind = "view" if "render" in cell else "step"
    assert _metrics(reg, cell)
    assert not set(ALL_METRICS) & set(res["metrics"])
    err = capsys.readouterr().err
    got = profiling.items()
    if cell == STAGE_CELL:          # the stage trainer opens no item
        assert got == [] and "[spans]" not in err
        return
    item_name = ITEM[cell]
    assert all(it["name"] == item_name for it in got)
    assert len(got) >= res["attempted"] + 1     # window + profiled item
    table = got[-1]["spans"]
    # the cell lists the metric of each span its item records, and no other
    assert set(_metrics(reg, cell)) == {m for m in METRICS[kind]
                                        if SPAN[m] in table}
    levels = 2
    if kind == "view":
        tiles = table["render.tile"]["count"]
        assert tiles >= 1 and table["render.assemble"]["count"] == 2
        for p in LEVEL_SPANS:
            assert table[p]["count"] == levels * tiles, p
        assert "model.encode" not in table
        if cell == VANILLA_CELL:
            # no rays or gathers; the levels' spans inside the tiles
            assert tiles > 1
            assert not {"model.rays", "model.gather"} & set(table)
            tile = table["render.tile"]
            assert tile["host_ms"] - tile["self_host_ms"] == pytest.approx(
                sum(table[p]["host_ms"] for p in LEVEL_SPANS))
        else:
            assert table["model.rays"]["count"] == tiles
    else:
        for p in ("train.loss", "train.backward", "train.update",
                  "model.encode"):
            assert table[p]["count"] == 1, p
        assert table["model.sample"]["count"] == levels
    for row in table.values():
        assert row["device_ms"] is None and row["timed"] == 0
        assert 0 <= row["self_host_ms"] <= row["host_ms"] + 1e-9
    assert f"[spans] {item_name} " in err


def _card_items(monkeypatch, tmp_path, cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    reg, res = _run_tiny(monkeypatch, tmp_path, cell, torch.device("cuda"))
    kind = "view" if "render" in cell else "step"
    for m in _metrics(reg, cell):
        assert res["metrics"][m]["value"] >= 0, m
    got = [it for it in profiling.items() if it["name"] == ITEM[cell]]
    assert len(got) >= res["attempted"] + 1
    return kind, got


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS[:2] + [VANILLA_CELL])
def test_spans_tile_the_device_timeline_on_the_card(cell, monkeypatch,
                                                    tmp_path):
    """Every tile marked: each item's phases tile its device timeline,
    neither overlapping (the children exceed the parent by at most a
    marker's resolution each) nor leaving a gap (they cover 95%). A
    vanilla NeRF tile at the tiny size is some 135 short launches, and
    its output copies with the gaps around them, in `render.tile` but
    outside the model's spans, took 5.2% of a view: its view is tiled by
    `render.assemble` and `render.tile`, and its tiles, 85% or more, by
    the levels' spans."""
    monkeypatch.setattr(loop, "MARKED_TILES", 1)
    kind, got = _card_items(monkeypatch, tmp_path, cell)
    tick = 5e-4                     # a timing event's resolution, ms
    children = (("render.assemble", "model.rays", "model.sample",
                 "model.gather", "model.mlp", "model.composite")
                if kind == "view" else
                ("train.loss", "train.backward", "train.update"))
    if cell == VANILLA_CELL:
        children = ("render.assemble", "render.tile")
    for it in got:
        table = it["spans"]
        n = sum(row["count"] for row in table.values())
        for name, row in table.items():
            assert row["timed"] == row["count"], name
            assert row["device_ms"] >= 0, name
            # children never exceed their parent by more than a tick each
            assert row["self_device_ms"] >= -tick * n, (name, row)
        top = table[ITEM[cell]]
        below = sum(table[c]["device_ms"] for c in children)
        assert top["device_ms"] > 0
        assert 0.95 * top["device_ms"] <= below <= \
            top["device_ms"] + tick * n, (below, top)
        if cell == VANILLA_CELL:
            tiles = table["render.tile"]["device_ms"]
            inner = sum(table[p]["device_ms"] for p in LEVEL_SPANS)
            assert 0.85 * tiles <= inner <= tiles + tick * n, (inner, tiles)


@pytest.mark.cuda
def test_one_tile_in_marked_tiles_is_timed_on_the_card(monkeypatch,
                                                       tmp_path):
    kind, got = _card_items(monkeypatch, tmp_path, "neo360.render_view")
    for it in got:
        table = it["spans"]
        tiles = table["render.tile"]["count"]
        timed = -(-tiles // loop.MARKED_TILES)
        assert table["render.tile"]["timed"] == timed
        assert table["model.mlp"]["timed"] == 2 * timed
        assert table["render.view"]["timed"] == 1
        assert table["render.view"]["self_device_ms"] is None
        assert all(row["device_ms"] >= 0 for row in table.values())


# ------------------------------------------------------------ MipNeRF-360
MIP_CELL = "mipnerf360.train_step"
MIP_SPANS = ("model.sample", "model.ipe", "model.mlp", "model.composite")
MIP_METRICS = {"sample_device_ms.train": "model.sample",
               "ipe_device_ms.train": "model.ipe"}


def _run_mip(monkeypatch, device):
    from benchmark.registry import Registry
    from benchmark.tests.support import adapter
    monkeypatch.setattr(run, "forbidden_modules", lambda: [])
    reg = Registry()
    config = reg.config(reg.workload(MIP_CELL)["config"])
    profiling.clear()
    with adapter(reg, MIP_CELL).tiny(config) as over:
        res = run.run_cell(reg, MIP_CELL, 3_000_000_019, 0.3, True, device,
                           over)
    return reg, res


def test_a_mip_step_records_its_model_spans_inside_the_loss(monkeypatch,
                                                            capsys):
    """Per step: sample, ipe, mlp and composite once a level (3 levels),
    the regularizers once, all of them children of `train.loss`; the two
    new metrics are listed for the cell and read nothing on the CPU."""
    reg, res = _run_mip(monkeypatch, torch.device("cpu"))
    assert set(MIP_METRICS) <= {m["name"] for m in reg.metrics(MIP_CELL,
                                                               True)}
    assert not set(MIP_METRICS) & set(res["metrics"])
    got = profiling.items()
    assert all(it["name"] == "train.step" for it in got)
    assert len(got) >= res["attempted"] + 1
    for it in got:
        table = it["spans"]
        for p in MIP_SPANS:
            assert table[p]["count"] == 3, p
        assert table["model.regularizers"]["count"] == 1
        for p in ("train.loss", "train.backward", "train.update"):
            assert table[p]["count"] == 1, p
        loss = table["train.loss"]
        children = sum(table[p]["host_ms"] for p in
                       ("model.sample", "model.composite",
                        "model.regularizers", "model.ipe", "model.mlp"))
        assert loss["host_ms"] - loss["self_host_ms"] == \
            pytest.approx(children, rel=1e-9, abs=1e-9)
        assert table["train.backward"]["self_host_ms"] == \
            table["train.backward"]["host_ms"]
    err = capsys.readouterr().err
    for p in MIP_SPANS + ("model.regularizers",):
        assert f"[spans] {p} " in err, p


def test_the_mip_readers_read_their_spans_per_step(monkeypatch):
    """sample_device_ms.train and ipe_device_ms.train through
    benchmark.spans: the median over the window's steps of their spans'
    device ms; nothing in a view."""
    from benchmark.registry import Registry
    reg = Registry()
    records = [_item("train.step", [("model.sample", 100.0 + i),
                                    ("model.ipe", 200.0 - i)], i)
               for i in range(5)]
    monkeypatch.setattr(profiling, "items", lambda: records)
    ctx = {"kind": "step", "items": 4, "trace": {"busy_s": 1.0},
           "steps_per_item": 1, "window_s": 0.4}
    # the window: steps 0-3 (step 4 is the profiled one); device ms 2 x
    assert reg.reader("sample_device_ms.train").read(ctx) == \
        pytest.approx(2 * 101.5)
    assert reg.reader("ipe_device_ms.train").read(ctx) == \
        pytest.approx(2 * 198.5)
    view = {"kind": "view", "items": 4, "trace": None, "steps_per_item": 1,
            "window_s": 0.4}
    for name in MIP_METRICS:
        assert reg.reader(name).read(view) is None


@pytest.mark.cuda
def test_a_mip_step_on_the_card_launches_e_and_e_prime_three_times(
        monkeypatch):
    """Every level composites with kernel E and its transpose E': 3 + 3
    launches a step; the two new metrics read every window step's
    spans."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    before = (kernels.launches["composite_mip_fwd"],
              kernels.launches["composite_mip_bwd"])
    _, res = _run_mip(monkeypatch, torch.device("cuda"))
    steps = 3 + res["attempted"] + 1        # warm-up, window, profiled
    assert kernels.launches["composite_mip_fwd"] - before[0] == 3 * steps
    assert kernels.launches["composite_mip_bwd"] - before[1] == 3 * steps
    for name in MIP_METRICS:
        assert res["metrics"][name]["value"] > 0, name
    for it in profiling.items():
        for p in MIP_SPANS:
            assert it["spans"][p]["timed"] == 3, p
