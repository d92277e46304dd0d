"""Readers shared by several metrics: metrics/<metric>.json names one under
"reader" (readers/<reader>.py), and its read(ctx, table) gets that file's
entries as `table`."""
