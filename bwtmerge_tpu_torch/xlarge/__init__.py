"""The xlarge tier: the k-way fold at 0.9 to 3.8 Gbp on one card.

Port of the JAX tree's `scripts/build_xlarge_fixtures.py` (fixtures.py),
`scripts/build_big_pieces.py` (big_pieces.py) and `bench_xlarge.py`
(bench.py).  Fixtures are built from a seed on the device and cached under
`.smoke_cache/xl/`:

    python -m bwtmerge_tpu_torch.xlarge.bench [--pieces N | --big N]
"""
