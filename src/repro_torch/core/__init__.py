"""Core analog-execution primitives (digital branch only in this slice)."""
