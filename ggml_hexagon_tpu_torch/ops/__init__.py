"""Ops: qp8 quantized matmuls, attention, elementwise (kernels + plain versions)."""
