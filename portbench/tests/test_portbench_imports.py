"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference and the yardstick import nothing of the program. Module names
are compared by their whole top-level name: ``ggad_tpu_torch`` begins
with ``ggad_tpu``."""

from __future__ import annotations

import ast
import subprocess
import sys

from portbench.tests.portbench_fixtures import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "ggad_tpu"}
# the yardstick: none of it may read the program
PLAIN = ("reference.py", "compare.py", "roofline.py", "graphgen.py",
         "weights.py", "tracing.py")


def top_level_imports(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_of_the_benchmark_names_jax_or_the_jax_package():
    for path in (REPO / "portbench").rglob("*.py"):
        assert not top_level_imports(path) & FORBIDDEN, path


def test_the_yardstick_imports_nothing_of_the_program():
    for name in PLAIN:
        assert "ggad_tpu_torch" not in top_level_imports(
            REPO / "portbench" / name), name


def test_a_run_loads_no_jax_and_the_reference_no_program():
    code = """
import sys, json
sys.path.insert(0, {repo!r})
import portbench.reference, portbench.compare, portbench.roofline
clean = sorted({{m.split('.')[0] for m in sys.modules}}
               & {{'ggad_tpu_torch', 'jax', 'jaxlib', 'flax', 'ggad_tpu'}})
from pathlib import Path
import tempfile
from portbench import graphgen, harness
from portbench.tests.portbench_fixtures import tiny_configs
d = Path(tempfile.mkdtemp())
graphgen.CACHE_DIR = d / 'cache'
spec = harness.load_spec(Path({repo!r}))
for e in spec['configs']:
    p = d / (e['name'] + '.json')
    p.write_text(json.dumps(tiny_configs()[e['name']]))
    e['file'] = str(p)
(d / 'BENCHMARK.json').write_text(json.dumps(spec))
harness.run(['--workload', 'tfinance.train', '--seed', '2', '--seconds',
             '0.2'], root=d, device='cpu')
print(json.dumps([clean, harness.forbidden_modules(),
                  'ggad_tpu_torch' in sys.modules]))
""".format(repo=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    clean, found, port = __import__("json").loads(
        proc.stdout.strip().splitlines()[-1])
    assert clean == [] and found == [] and port
