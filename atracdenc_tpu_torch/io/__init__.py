"""PCM file I/O."""
