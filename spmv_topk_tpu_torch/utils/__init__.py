"""Host utilities (native runtime bindings)."""
