"""The Cypher layer (counterpart of ``nornicdb_tpu/query``): tokenizer and
parser, the row interpreter (``executor.py``), the vectorized fast paths
over a columnar snapshot of the graph (``columnar.py``, ``fastpaths.py``,
numpy on the host, as in the reference), builtin functions, temporal
values, the ``db.*`` procedures and EXPLAIN/PROFILE.

Unlike the reference's, this package imports nothing when it loads: the
record codec imports ``temporal_types`` from it while storage loads, and
the executor imports storage.
"""
