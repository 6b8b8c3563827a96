"""The Program IR, its registry, scope, backward pass and executor."""
