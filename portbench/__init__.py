"""The benchmark of `arrowtpu_torch` on the H100, driven by data.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

`BENCHMARK.json` (at the repository's root) names the cells; each name
leads to files of its own here: `configs/<config>.json` (tables with their
generators and batch builders, scale, guarantees, cuts), `data/<generator>
.py` (a table's laws, drawn on the card from the seed; its own `batch`
where the table reaches the port another way than a batch builder), `traffic/<mix>.json`
(the launch, queries, weights, parameter draws; read by `mix.py`),
`launch/<launch>.py` (the processes and clients that drive the window),
`queries/<query>.py` (the tables it reads, the timed call into the port,
the reading of its output, the comparison) with `reference/<query>.py` (the
plain PyTorch answer, importing nothing of the port), and
`metrics/<metric>.py` (one reader a metric; every per-layer metric lists
its cells under `workloads` in `BENCHMARK.json`; a kernel's roofline names
the port's entry it meters, its kernels and its byte count, a layer's span
metric the package whose calls it times).  `harness.py` runs a cell,
`spans.py` and `devtrace.py` read a traced window, `roofline.py` holds the
card's peak, and `control.py` reads each cell's control at full size on
the card.  CPU tests: `python -m pytest portbench/tests`; `-m cuda` on a
machine with the card.
"""
