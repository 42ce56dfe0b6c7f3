"""The port's benchmark: frame streams through ``ConvStream`` on one card.

Run one cell once from the root of a checkout::

    python3 -m fftconv_bench.run --workload headline.same --seed 7 --seconds 10 --trace 0

``BENCHMARK.json`` names the cells; each cell's configuration, traffic mix,
limits and per-layer metric readers sit in files of their own under this
folder and are found by name (``spec.py``). The yardstick (traffic
generation, the float64 reference, the roofline counts, the comparison that
decides ``correct``) lives here and not in the program.
"""
