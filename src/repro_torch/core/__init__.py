"""Core math: the ALiBi factorization (``bias``), biased attention
(``attention``) and truncated-SVD bias factors (``decomp``)."""
