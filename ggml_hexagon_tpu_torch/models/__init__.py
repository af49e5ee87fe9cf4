"""Models: the Llama forward, weight fusion, the synthetic 8B build."""
