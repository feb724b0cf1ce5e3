"""The port's benchmark: one cell (a configuration under a traffic mix)
run once by ``python -m portbench.run``. See README.md."""
