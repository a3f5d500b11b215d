"""Evaluation plane of the port: symmetry-corrected RMSD, metric tables and
gnina rescoring, all on the host (numpy and scipy)."""
