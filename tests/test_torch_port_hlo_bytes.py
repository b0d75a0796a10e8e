"""The corrected byte model of ``utils/costs`` and its CLI,
``robust_pose_tpu_torch/scripts/hlo_bytes.py`` (the port of
``scripts/hlo_bytes.py``), on the CPU.

Exact naive and corrected bytes, counted by hand, for each gather and each
in-place scatter name the counter sees, the caps (a gather that emits more
than its table, a scatter with more updates than base rows) and the
out-of-place forms (corrected == naive). The JAX script's ``analyze`` on a
hand-written HLO text of one row gather and one row scatter (s64 indices,
no ``to_apply``) gives the port's corrected total for the same torch ops
exactly; with ``to_apply`` on the scatter line it charges the reduction's
name as the updates (3 x the output), which the port does not copy. The
CLI at 64x96 (``tests/test_torch_port_roofline.py``'s ``small`` fixture):
naive bytes equal to ``roofline.count_window``'s, corrected <= naive in
total and in every op row, rows summing to the totals; ``--measure-bw``
refuses the CPU, and without a card the CLI needs ``--device cpu``.
"""
import contextlib
import importlib.util
import io
import os
import re

import pytest
import torch
import torch.nn.functional as F

from robust_pose_tpu_torch.scripts import hlo_bytes, roofline
from robust_pose_tpu_torch.utils import costs
from tests.test_torch_port_roofline import small  # noqa: F401  (fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# a table of 64 rows of 8 f32 (2,048 B), 16 int64 row indices (128 B), 16
# rows gathered or scattered (512 B)
TABLE_B, IDX_B, ROWS_B = 64 * 8 * 4, 16 * 8, 16 * 8 * 4


def _inputs():
    g = torch.Generator().manual_seed(0)
    table = torch.randn(64, 8, generator=g)
    idx = torch.randperm(64, generator=g)[:16]
    src = torch.randn(16, 8, generator=g)
    return table, idx, src, idx[:, None].repeat(1, 8)


def _one_op(fn):
    """(naive, corrected) bytes of the single op ``fn`` runs."""
    with costs.count() as c:
        fn()
    assert len(c.by_op) == 1, dict(c.by_op)
    (name, (flops, naive, calls)), = c.by_op.items()
    assert calls == 1 and c.corrected_by_op[name] == [c.bytes_corrected, 1]
    return name, naive, c.bytes_corrected


GATHERS = {
    "index": lambda t, i, i2: t[i],
    "index_select": lambda t, i, i2: t.index_select(0, i),
    "gather": lambda t, i, i2: t.gather(0, i2),
    "embedding": lambda t, i, i2: F.embedding(i, t),
}


@pytest.mark.parametrize("op", sorted(GATHERS))
def test_row_gather_reads_what_it_emits(op):
    """16 rows of a 64-row table: the indices and the emitted rows read, the
    rows written; naive charges the whole table. ``gather`` reads a
    (16, 8) int64 index."""
    table, idx, _, idx2 = _inputs()
    idx_b = IDX_B * (8 if op == "gather" else 1)
    name, naive, corr = _one_op(lambda: GATHERS[op](table, idx, idx2))
    assert name == op
    assert naive == TABLE_B + idx_b + ROWS_B
    assert corr == idx_b + 2 * ROWS_B


def test_take_and_take_along_dim_gather_elements():
    """``take`` reads 16 f32 elements; ``take_along_dim`` reaches ``gather``
    (after a ``remainder`` of its index, charged as naive)."""
    table, idx, _, ix = _inputs()
    name, naive, corr = _one_op(lambda: table.take(idx))
    assert (name, naive, corr) == ("take", TABLE_B + IDX_B + 64,
                                   IDX_B + 2 * 64)
    with costs.count() as c:
        torch.take_along_dim(table, ix, 0)
    assert c.by_op["gather"][1] == TABLE_B + 8 * IDX_B + ROWS_B
    assert c.corrected_by_op["gather"] == [8 * IDX_B + 2 * ROWS_B, 1]
    assert c.corrected_by_op["remainder"][0] == c.by_op["remainder"][1]


def test_gather_that_emits_more_than_its_table_reads_it_once():
    """1,000 rows (32,000 B) from a 2,048 B table: the read is capped at the
    table, so corrected == naive here."""
    table = _inputs()[0]
    idx = torch.randint(0, 64, (1000,), generator=torch.Generator().manual_seed(1))
    name, naive, corr = _one_op(lambda: table[idx])
    assert corr == 1000 * 8 + TABLE_B + 1000 * 32 == naive


def _base():
    return torch.zeros(64, 8)


SCATTERS = {
    # name: (call on (base, idx, src, idx as (16, 8)), index bytes,
    # update bytes)
    "scatter_": (lambda b, i, s, i2: b.scatter_(0, i2, s), 8 * IDX_B, ROWS_B),
    "scatter_add_": (lambda b, i, s, i2: b.scatter_add_(0, i2, s), 8 * IDX_B,
                     ROWS_B),
    "scatter_reduce_": (lambda b, i, s, i2: b.scatter_reduce_(
        0, i2, s, reduce="amax"), 8 * IDX_B, ROWS_B),
    "index_put_": (lambda b, i, s, i2: b.__setitem__(i, s), IDX_B, ROWS_B),
    "_index_put_impl_": (lambda b, i, s, i2: torch.ops.aten._index_put_impl_(
        b, (i,), s, False, False), IDX_B, ROWS_B),
    "index_add_": (lambda b, i, s, i2: b.index_add_(0, i, s), IDX_B, ROWS_B),
    "index_copy_": (lambda b, i, s, i2: b.index_copy_(0, i, s), IDX_B, ROWS_B),
    "index_fill_": (lambda b, i, s, i2: b.index_fill_(0, i, 3.0), IDX_B, 0),
}


@pytest.mark.parametrize("op", sorted(SCATTERS))
def test_inplace_scatter_touches_only_what_it_indexes(op):
    """16 rows into a 64-row base: indices and updates read, the 16 touched
    rows read and written (2 x 512 B); naive charges the base read and
    written whole."""
    _, idx, src, idx2 = _inputs()
    fn, idx_b, upd_b = SCATTERS[op]
    base = _base()
    name, naive, corr = _one_op(lambda: fn(base, idx, src, idx2))
    assert name == op
    assert naive == 2 * TABLE_B + idx_b + upd_b
    assert corr == idx_b + upd_b + 2 * ROWS_B


def test_scatter_reduce_with_more_updates_than_base_rows_is_capped():
    """128 updates into a 4-row base (32 elements): the touched elements are
    capped at the base's 128 B, so corrected == naive here."""
    g = torch.Generator().manual_seed(2)
    base = torch.zeros(4, 8)
    idx = torch.randint(0, 4, (16, 8), generator=g)
    src = torch.randn(16, 8, generator=g)
    name, naive, corr = _one_op(lambda: base.scatter_reduce_(0, idx, src, "amax"))
    assert corr == 16 * 8 * 8 + 16 * 8 * 4 + 2 * 128 == naive


def test_masked_index_put_touches_the_set_elements():
    """``b[mask] = 1.0`` with 80 set elements: the bool mask (512 B) and the
    0-d value (4 B) read, 80 f32 elements read and written."""
    base = _base()
    mask = torch.zeros(64, 8, dtype=torch.bool)
    mask[:10] = True
    value = torch.tensor(1.0)
    name, naive, corr = _one_op(lambda: base.__setitem__(mask, value))
    assert name == "index_put_"
    assert naive == 2 * TABLE_B + 512 + 4
    assert corr == 512 + 4 + 2 * 80 * 4


def test_index_put_over_a_middle_dimension():
    """``b[:, i] = s`` indexes dimension 1 of a (4, 64, 2) base: 4 x 16 x 2
    elements touched."""
    g = torch.Generator().manual_seed(3)
    base = torch.zeros(4, 64, 2)
    idx = torch.randperm(64, generator=g)[:16]
    src = torch.randn(4, 16, 2, generator=g)

    def put():
        base[:, idx] = src
    name, naive, corr = _one_op(put)
    assert name == "index_put_"
    assert corr == IDX_B + 4 * 16 * 2 * 4 * 3


OUT_OF_PLACE = {
    "index_copy": (lambda b, i, s, i2: b.index_copy(0, i, s), IDX_B),
    "scatter": (lambda b, i, s, i2: b.scatter(0, i2, s), 8 * IDX_B),
    "index_put": (lambda b, i, s, i2: b.index_put((i,), s), IDX_B),
}


@pytest.mark.parametrize("op", sorted(OUT_OF_PLACE))
def test_out_of_place_scatter_keeps_the_naive_charge(op):
    """Eager PyTorch copies the whole base before it scatters: base read,
    output written, indices and updates read, in both models."""
    _, idx, src, idx2 = _inputs()
    fn, idx_b = OUT_OF_PLACE[op]
    base = _base()
    name, naive, corr = _one_op(lambda: fn(base, idx, src, idx2))
    assert name == op
    assert corr == naive == 2 * TABLE_B + idx_b + ROWS_B


# ---------------------------------------------------------------------------
# parity with the JAX script's analyze
# ---------------------------------------------------------------------------

HLO = """HloModule rows, entry_computation_layout={(f32[4096,8]{1,0}, s64[512,1]{1,0}, f32[512,8]{1,0})->(f32[512,8]{1,0}, f32[4096,8]{1,0})}

%region_0.1 (Arg_0.2: f32[], Arg_1.3: f32[]) -> f32[] {
  %Arg_0.2 = f32[] parameter(0)
  %Arg_1.3 = f32[] parameter(1)
  ROOT %maximum.4 = f32[] maximum(%Arg_0.2, %Arg_1.3)
}

ENTRY %main.9 (Arg_0.1: f32[4096,8], Arg_1.2: s64[512,1], Arg_2.3: f32[512,8]) -> (f32[512,8], f32[4096,8]) {
  %Arg_0.1 = f32[4096,8]{1,0} parameter(0)
  %Arg_1.2 = s64[512,1]{1,0} parameter(1)
  %gather.5 = f32[512,8]{1,0} gather(%Arg_0.1, %Arg_1.2), offset_dims={1}, collapsed_slice_dims={0}, start_index_map={0}, index_vector_dim=1, slice_sizes={1,8}
  %Arg_2.3 = f32[512,8]{1,0} parameter(2)
  %scatter.6 = f32[4096,8]{1,0} scatter(%Arg_0.1, %Arg_1.2, %Arg_2.3), update_window_dims={1}, inserted_window_dims={0}, scatter_dims_to_operand_dims={0}, index_vector_dim=1{to_apply}
  ROOT %tuple.7 = (f32[512,8]{1,0}, f32[4096,8]{1,0}) tuple(%gather.5, %scatter.6)
}
"""
OUT_B, UPD_B, S64_B = 4096 * 8 * 4, 512 * 8 * 4, 512 * 8


def jax_corrected(to_apply=""):
    """The JAX script's corrected total for ``HLO``, in bytes: with
    ``n_frames=1e-9`` its "GB/frame" field prints bytes."""
    spec = importlib.util.spec_from_file_location(
        "jax_hlo_bytes", os.path.join(ROOT, "scripts", "hlo_bytes.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        mod.analyze(HLO.replace("{to_apply}", to_apply), 5, n_frames=1e-9)
    m = re.search(r"corrected true-HBM estimate:.*\(([0-9.]+) GB/frame\)",
                  out.getvalue())
    return float(m.group(1))


ROW_GATHERS = {"index": lambda t, i: t[i],
               "index_select": lambda t, i: t.index_select(0, i)}
ROW_SCATTERS = {"index_copy_": lambda b, i, s: b.index_copy_(0, i, s),
                "index_put_": lambda b, i, s: b.index_put_((i,), s),
                "scatter_": lambda b, i, s: b.scatter_(0, i.expand(8, -1).t(), s)}


@pytest.mark.parametrize("scatter", sorted(ROW_SCATTERS))
@pytest.mark.parametrize("gather", sorted(ROW_GATHERS))
def test_corrected_total_equals_the_jax_script_without_to_apply(gather, scatter):
    """A row gather and an in-place row scatter of (512, 8) f32 rows by 512
    int64 indices over a (4096, 8) f32 table: the port's corrected bytes
    equal ``analyze``'s on the same HLO ops (gather 2 x 16,384 + 4,096,
    scatter 4,096 + 3 x 16,384)."""
    g = torch.Generator().manual_seed(4)
    table = torch.randn(4096, 8, generator=g)
    base = table.clone()
    idx = torch.randperm(4096, generator=g)[:512]
    src = torch.randn(512, 8, generator=g)
    with costs.count() as c:
        ROW_GATHERS[gather](table, idx)
        ROW_SCATTERS[scatter](base, idx, src)
    want = (2 * UPD_B + S64_B) + (S64_B + 3 * UPD_B)
    assert c.bytes_corrected == want == jax_corrected()
    assert c.bytes > c.bytes_corrected


def test_jax_script_charges_to_apply_as_the_updates():
    """Compiled HLO carries ``to_apply=%region`` on every scatter line. The
    JAX script's operand list then ends in the reduction's name, which is
    not an instruction: the updates fall back to the whole output and the
    scatter costs indices + updates + 3 x the output, more than the naive
    count. The port does not copy this (its rule is the docstring's)."""
    jax_total = jax_corrected(", to_apply=%region_0.1")
    assert jax_total == (2 * UPD_B + S64_B) + (S64_B + UPD_B + 3 * OUT_B)
    naive = (OUT_B + S64_B + UPD_B) + (OUT_B + S64_B + UPD_B + OUT_B)
    assert jax_total > naive > jax_corrected()


# ---------------------------------------------------------------------------
# the CLI at 64x96
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", ["f2f", "f2m"])
def test_cli_counts_the_roofline_window(small, path, capsys):
    """The CLI's naive bytes are ``roofline.count_window``'s for the same
    window (f2m: the pool sized to the window); corrected <= naive in total
    and in every op row; the corrected rows sum to the corrected total by
    op, by span and by (span, op, signature); the JSON line is the
    returned dict."""
    import json

    out = hlo_bytes.main(["--device", "cpu", "--path", path, "--window", "2",
                          "--top", "5", "--frame-ms", "10"])
    printed = capsys.readouterr().out.splitlines()
    assert json.loads(printed[-1]) == json.loads(json.dumps(out))
    assert any(l.startswith("corrected byte estimate") for l in printed)
    c = roofline.count_window(path, "cpu", 2, pool_frames=2 if path == "f2m" else None)
    assert out["naive_bytes"] == c.bytes and out["corrected_bytes"] == c.bytes_corrected
    assert 0 < out["corrected_bytes"] <= out["naive_bytes"]
    assert out["by_op_naive"].keys() == out["by_op_corrected"].keys()
    for op, (b, calls) in out["by_op_corrected"].items():
        assert b <= out["by_op_naive"][op][1] and calls == out["by_op_naive"][op][2]
    assert sum(b for b, _ in out["by_op_corrected"].values()) == out["corrected_bytes"]
    assert sum(out["by_span_corrected"].values()) == out["corrected_bytes"]
    assert sum(b for b, _ in c.corrected_rows.values()) == c.bytes_corrected
    assert len(out["top_rows"]) == 5
    assert out["util_pct"] == pytest.approx(
        100 * out["corrected_bytes"] / 2 / costs.HBM_BYTES_PER_S * 1e3 / 10)
    for k in ("measured_bytes_per_s", "util_pct_measured", "device", "power_limit"):
        assert out[k] is None, k
    if path == "f2m":
        # the surfel map's row gathers and in-place scatters are charged
        # less than naive
        assert out["corrected_bytes"] < out["naive_bytes"]
        assert out["by_op_corrected"]["index"][0] < out["by_op_naive"]["index"][1]


def test_roofline_rows_carry_the_corrected_bytes(small):
    rows = roofline.main(["--device", "cpu", "--window", "2", "--windows", "1",
                          "--skip-f2m"])
    r, = rows
    assert 0 < r["hbm_gb_per_frame_corrected"] <= r["hbm_gb_per_frame"]
    assert r["hbm_util_pct_corrected"] is None


def test_measure_bw_refuses_the_cpu():
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        hlo_bytes.main(["--device", "cpu", "--measure-bw"])


def test_cli_needs_a_device_choice_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: cuda is the default here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        hlo_bytes.main([])
