"""Block library: LayerNorms, convs, resamplers, MDTA attention, GDFN."""
