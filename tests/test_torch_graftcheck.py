"""graftcheck over the port: the JAX package's static analyzer
(``langstream_tpu/analysis``), run over ``langstream_tpu_torch/`` against
the port's own baseline (``tests/fixtures/torch_graftcheck_baseline.json``).

The gate is ``tests/test_graftcheck.py``'s: no finding outside the
baseline (per-file and project rules, the project index built from the
port's files alone, since the port imports nothing of the JAX package),
no stale baseline entry, no stale suppression, no unparseable file. Every
baseline entry names why the finding does not hold for the port.
"""

import json
from pathlib import Path

from langstream_tpu.analysis import ALL_RULES, PROJECT_RULES, load_baseline, run
from langstream_tpu.analysis.core import iter_py_files

REPO = Path(__file__).resolve().parent.parent
BASELINE = Path(__file__).parent / "fixtures" / "torch_graftcheck_baseline.json"


def test_the_port_is_clean_against_its_own_baseline():
    """Zero new and zero stale findings over the port, each baseline entry
    with a reason, inside the JAX gate's 60 s budget."""
    entries = load_baseline(BASELINE)
    assert all(e.reason.strip() for e in entries), "every baseline entry needs a reason"
    assert isinstance(json.loads(BASELINE.read_text()), list)
    files = list(iter_py_files(REPO / "langstream_tpu_torch"))
    report = run(ALL_RULES, files=files, baseline=entries, repo_root=REPO,
                 project_rules=PROJECT_RULES, project_files=files)
    problems = [f.format() for f in report.new]
    problems += [f"STALE BASELINE {e.rule} {e.path} [{e.symbol}]"
                 for e in report.stale_baseline]
    problems += [f"PARSE ERROR {p}" for p in report.parse_errors]
    assert not problems, (
        "graftcheck findings in the port (fix them, suppress inline with a reason, "
        "or baseline them with one):\n" + "\n".join(problems))
    assert report.analysis_seconds < 60.0
