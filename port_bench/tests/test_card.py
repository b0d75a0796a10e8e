"""On the card: each cell's whole run at its own size for a short window
(``python3 -m pytest port_bench/tests -m card``); without a card these
skip."""
from pathlib import Path

import pytest

from port_bench import cells, run

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in cells.benchmark(ROOT)["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_cell_is_correct_on_the_card(workload, card):
    r = run.run_cell(workload, 2 ** 31 + 5, 2.0, True, card, ROOT)
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["busy_s"] > 0
    assert r["metrics"]
