"""decoder.recon_ms_per_frame: H264Decoder(stage_times=True)'s
stage_seconds["inter_intra_recon"] (each stage ended by a device
synchronize) over the staged part of the traced run, per picture
returned there."""


def read(rec):
    if rec["side"] != "decode" or not rec.get("staged_frames"):
        return None
    return (1e3 * rec["stage_seconds"]["inter_intra_recon"]
            / rec["staged_frames"])
