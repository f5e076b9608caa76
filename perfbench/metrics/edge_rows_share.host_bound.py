"""``edge_rows_share`` of the host-bound cell, where it moves
``clouds_per_s.host_bound``: the same reader."""
from perfbench.harness.spec import reader_of

read = reader_of("edge_rows_share")
