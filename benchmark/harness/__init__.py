"""The benchmark's harness: the general code that every cell shares.

A cell is found by name: ``workloads/<cell>.json`` (its traffic and
window), ``configs/<config>.json`` (the deployment), ``layers/*.json``
(the spans of each layer) and ``metrics/<metric>.py`` (the reader of each
per-layer metric). Adding a cell, a configuration, a layer or a metric
adds files and edits none.
"""
