"""The Program IR, its registry, scope, backward pass and executor."""
from .program import (Block, Operator, Parameter, Program, Variable,
                      default_main_program, default_startup_program,
                      maybe_recompute, program_guard, recompute_guard)

__all__ = ["Block", "Operator", "Parameter", "Program", "Variable",
           "default_main_program", "default_startup_program",
           "maybe_recompute", "program_guard", "recompute_guard"]
