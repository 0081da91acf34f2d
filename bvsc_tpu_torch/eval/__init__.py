"""Evaluation: objective metrics (``metrics``), the PESQ-WB model
(``pesq``) and MUSHRA listening-test statistics (``mushra``)."""
