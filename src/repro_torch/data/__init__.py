"""Corpus inputs of the port (port of ``repro.data``): synthetic corpora,
the text pipeline, and out-of-core corpora with their prefetcher."""
from repro_torch.data.corpus import (
    CORPUS_FORMAT, ChunkPackError, ChunkSource, CorpusIntegrityError,
    DenseChunks, MmapCorpus, Prefetcher, ResidentChunks, StagedChunk,
    as_chunk_source, chunk_schedule, is_corpus_input, open_corpus,
    stage_chunk, write_corpus,
)
from repro_torch.data.synthetic import (
    synthetic_corpus_matrix, synthetic_journal_corpus,
)
from repro_torch.data.textpipe import (
    STOPWORDS, build_term_document_matrix, normalize_rows_by_nnz, tokenize,
)

__all__ = ["CORPUS_FORMAT", "ChunkPackError", "ChunkSource",
           "CorpusIntegrityError", "DenseChunks", "MmapCorpus", "Prefetcher",
           "ResidentChunks", "STOPWORDS", "StagedChunk", "as_chunk_source",
           "build_term_document_matrix", "chunk_schedule", "is_corpus_input",
           "normalize_rows_by_nnz", "open_corpus", "stage_chunk",
           "synthetic_corpus_matrix", "synthetic_journal_corpus", "tokenize",
           "write_corpus"]
