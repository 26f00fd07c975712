"""How a cell runs, by its traffic's ``kind``: ``train`` or ``prefill``.
Each module's ``run(cell)`` makes the inputs, sets up and warms the
program, measures the window (or traces it), reads the peak, frees the
program and compares what the window produced with the reference."""
