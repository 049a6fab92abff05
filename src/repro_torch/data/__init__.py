from repro_torch.data.synthetic import TokenStream, make_higgs_like, make_secom_like, token_batch

__all__ = ["TokenStream", "make_higgs_like", "make_secom_like", "token_batch"]
