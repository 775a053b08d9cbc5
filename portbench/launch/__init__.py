"""The launches a mix can name, one module each: `run(cell, seed, seconds,
trace, t_start)` starts the processes and clients that drive the cell's
window on its cards and returns the result's line (`harness.run_cell` does
it for one process on one card).  Another layout, such as one process a
card or several clients on one card, is a module of its own, built from
the harness's parts."""
