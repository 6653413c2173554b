// Document: xref resolution (classic tables, xref streams, object streams,
// broken-file reconstruction) and page-tree walking.
#pragma once

#include <map>
#include <set>
#include <string>
#include <vector>

#include "obj.h"

namespace pdfio {

struct XrefEntry {
  int type = 0;      // 0 free, 1 offset, 2 in object stream
  size_t offset = 0; // type 1: byte offset; type 2: object-stream number
  int gen = 0;       // type 1: generation; type 2: index within stream
};

struct Page {
  PObj node;       // the /Page dict
  PObj resources;  // inherited-resolved
  double media[4] = {0, 0, 612, 792};
  int rotate = 0;
};

class Document {
 public:
  // Takes ownership of nothing; data must outlive the Document.
  bool open(const uint8_t* data, size_t len, std::string* err);

  PObj resolve(PObj o);               // follow Ref chains (cycle-safe)
  PObj get(int num);                   // object by number
  PObj dget(const PObj& dict, const std::string& key) {
    return dict ? resolve(dict->at(key)) : nullptr;
  }
  double dnum(const PObj& dict, const std::string& key, double dflt) {
    PObj v = dget(dict, key);
    return v && v->is_num() ? v->num() : dflt;
  }

  int page_count() const { return (int)pages_.size(); }
  const Page& page(int i) const { return pages_[i]; }

  std::vector<uint8_t> decoded(const PObj& stream, std::string* passthrough = nullptr) {
    return decode_stream(this, stream, passthrough);
  }

  const uint8_t* data() const { return d_; }
  size_t size() const { return n_; }

 private:
  bool parse_xref_at(size_t offset, int depth);
  bool parse_xref_table(Parser& p);
  bool parse_xref_stream(PObj stream);
  void reconstruct_xref();
  void build_pages(PObj node, PObj inherited_res, const double* inherited_mb,
                   int inherited_rot, int depth);
  PObj load_from_objstm(int stm_num, int idx);

  const uint8_t* d_ = nullptr;
  size_t n_ = 0;
  std::map<int, XrefEntry> xref_;
  std::map<int, PObj> cache_;
  std::set<int> loading_;  // cycle guard
  PObj trailer_;
  std::vector<Page> pages_;
};

}  // namespace pdfio
