"""Host-side helpers: bit packing, native library loading."""
