"""Entry points: build_model, load_params, infer, robust."""
