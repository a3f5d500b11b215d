"""Categorical feature widths of the port's featurization
(``data/featurize.py``: the lengths of ``ALLOWABLE_FEATURES``' lists),
frozen as numbers."""

LIG_CATEGORICAL_DIMS = (119, 4, 12, 12, 8, 10, 6, 6, 2, 8, 2, 2, 2, 2, 2, 2)
REC_CATEGORICAL_DIMS = (38,)
REC_ATOM_CATEGORICAL_DIMS = (38, 119, 23, 38)
