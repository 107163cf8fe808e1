"""Sequence I/O: FASTA queries/databases, NCBI BLAST v4 databases, deflines."""
