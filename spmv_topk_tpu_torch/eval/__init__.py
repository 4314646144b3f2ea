from . import metrics
from .accuracy_model import closed_form_precision, monte_carlo_precision
