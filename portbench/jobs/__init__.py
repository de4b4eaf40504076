"""Job kinds: one module a kind, named by a configuration's ``job`` key, each
with a ``Job`` class (``common.Job``'s interface)."""
