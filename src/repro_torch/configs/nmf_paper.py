"""The paper's own NMF experiment configurations (§3), a copy of the
reference's ``repro.configs.nmf_paper``."""

NMF_CONFIGS = {
    # Reuters-21578: 6,424 terms x 1,985 documents, 5 topics (Fig. 2/3)
    "reuters": dict(n_terms=6424, n_docs=1985, k=5, iters=75),
    # Wikipedia: 143,462 terms x 12,439 pages, 5 topics (Table 1 / Fig. 7)
    "wikipedia": dict(n_terms=143462, n_docs=12439, k=5, iters=50),
    # PubMed journals: 20,112 terms x 7,510 abstracts, 5 topics (Fig. 4-6, 9)
    "pubmed": dict(n_terms=20112, n_docs=7510, k=5, iters=50, n_journals=5),
    # "Large" production-scale synthetic target for the distributed dry-run
    "large-synthetic": dict(n_terms=4_000_000, n_docs=1_000_000, k=256, iters=20),
}
