"""The reference's controller, plant and lanes tick."""
