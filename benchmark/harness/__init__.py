"""The benchmark's harness: `main` (one run of one cell), `drivers` (the
traffic paths), `trace` (spans and the device timeline), `roofline` and
`peaks.json` (the frozen yardstick of the kernels), `control`."""
