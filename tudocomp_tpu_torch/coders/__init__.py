"""Entropy coders of the port: the canonical Huffman table."""
