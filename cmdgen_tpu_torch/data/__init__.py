"""Host-side data pipelines emitting fixed-shape padded batches."""
