"""Small companion utilities (reference: src/lib/liboma/tools)."""
