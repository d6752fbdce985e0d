"""The paper's experiments on the port (port of the paper sections of
``benchmarks/``): Table I's RMSE (``t1_rmse``) and accuracy
(``t1_accuracy``) rows, Table II's LLM rows (``t2_llm``), Table III with
Fig. 4 (``t3_efficiency``), Fig. 6(c) (``fig6_sparsity``) and the Sec.
IV-C PRNG/seed search (``seedsearch``).  Each module's ``run()`` returns
the reference's row dicts and ``main()`` prints its CSV lines;
``python -m repro_torch.paper [section ...]`` runs them in turn.  Nothing
is appended to any file."""

SECTIONS = ("t1_rmse", "fig6_sparsity", "t3_efficiency", "seedsearch",
            "t1_accuracy", "t2_llm")

__all__ = ["SECTIONS"]
