"""Core math: the bias factorizations (``bias``), biased attention
(``attention``), truncated-SVD bias factors (``decomp``) and the low-rank
measurements and IO model (``lowrank``)."""
