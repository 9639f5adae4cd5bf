"""Core math: the ALiBi factorization (``bias``) and biased attention
(``attention``)."""
