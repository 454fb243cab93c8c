"""Reporting layer: figures and LaTeX artifact generators (L5). The
figures import matplotlib only when one is drawn."""

from . import figures
from .latex import (
    compliance_latex_table,
    confidence_compliance_latex_table,
    perturbation_latex_table,
    standalone_latex_document,
)
