"""Each cell at a size the CPU tests can hold: the same configurations,
mixes and code paths, fewer ids, rows and requests.  A cell's sizes are
its own file ``scales/<workload>.json`` (the keys of ``run.scaled``), so
a cell added as new files brings its CPU tests' sizes with it."""

import json
from pathlib import Path

SCALES = {p.stem: json.loads(p.read_text())
          for p in sorted((Path(__file__).parent / "scales").glob("*.json"))}
SECONDS = 1.0
