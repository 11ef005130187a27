"""Closed-form operation and byte counts of the configurations' work,
from the published widths and the batch's shape, whatever implements it."""
