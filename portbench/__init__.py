"""The benchmark of the port (``src/repro_torch``) on one H100: one run of
one cell is ``python3 portbench/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>`` (see ``harness.py``).  It imports neither JAX
nor the JAX package; the yardstick (corpus, model weights and prompts,
references, byte and operation counts, the check) lives here, where no
change to the program can move it."""
