raise ImportError("repro_torch.core.mutation was removed; import from "
                  "repro_torch.core.edits (re-exported by repro_torch.core)")
